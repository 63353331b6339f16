"""``core.drive``'s step graph: a CUDA state stepped by replaying
``GRAPH_STEPS`` captured steps equals the eager step, leaf for leaf and
bit for bit.

On the card (marked ``gpu``; skip where no CUDA card is present): every
leaf of ``drive``'s final state equals a loop of eager ``step_batch``
calls run as ``drive`` ran before it had a graph, for raft (the
flagship's fields), etcd (``hist_slots=256``), kafka and S3 at their
defaults, raft with a ``FaultEnvelope``'s per-lane ``params=``, a second,
ragged width (its own capture), and ``max_steps`` that are no multiple of
``GRAPH_STEPS``; pop-min's launches equal the steps run, each graph's
capture took in one launch a step, and ``drive.graph_steps`` counts the
replayed ones; a returned final is left as it was by a later ``drive``
call; a workload built anew from the same config replays the graph
captured for the first. Run there with ``python -m pytest
tests/test_torch_drive_graph.py -m gpu -q`` (this file imports no JAX).

On the CPU: ``drive`` never captures (``graph_steps`` stays 0, the
results are the eager loop's); the graph's body (``_steps_into``) stepped
in place equals ``GRAPH_STEPS`` eager steps for every model; ``drive``'s
replay, leftover and copy logic and the graph cache, rehearsed with a
stand-in graph whose replay runs that body eagerly (equal workloads share
a graph, a capture that does not take in one pop-min launch a step
raises, ``compiles.count_compiles`` counts a capture, and
``sweep_million``'s warm-up captures every width its timed loop runs);
``core.StepCount``
on the eager paths; and the pipelined driver observes
``sweep_chunk_graph_steps`` per chunk.
"""

from collections import OrderedDict
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from madsim_tpu_torch.engine import checkpoint, compiles, core, cuda_queue, faults, tree
from madsim_tpu_torch.models import etcd, raft

K = core.GRAPH_STEPS


def _eager_drive(wl, ecfg, state):
    """``drive`` as it ran before the graph: ``CHECK_EVERY`` eager steps
    between live-count reads; returns ``(final, block sizes)``."""
    steps, blocks = 0, []
    while steps < ecfg.max_steps and int((~state.done).sum()) > 0:
        n = min(core.CHECK_EVERY, ecfg.max_steps - steps)
        for _ in range(n):
            state = core.step_batch(wl, ecfg, state, device=state.now_ns.device)
        steps += n
        blocks.append(n)
    return state, blocks


def _replayed(blocks):
    """Steps a graph serves: all but the ``n % K`` of a short last block."""
    return sum(blocks) - (blocks[-1] % K if blocks else 0)


def _assert_equal(got, want):
    a, b = tree.leaves(got), tree.leaves(want)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert torch.equal(x, y), f"leaf {i} differs"


def _counters():
    return (core.drive.steps, core.drive.graph_steps, cuda_queue.pop_min_decision.launches)


def _drive_counted(wl, ecfg, state):
    """``drive`` with the change of its three counters."""
    before = _counters()
    final = core.drive(wl, ecfg, state)
    steps, graph_steps, launches = (b - a for a, b in zip(before, _counters()))
    return final, steps, graph_steps, launches


# ---- the models, at the card's sizes and (shorter horizons) the CPU's

def _raft(horizon_ns=None):
    wl, ecfg = chip_smoke.flagship()
    return wl, ecfg if horizon_ns is None else ecfg._replace(time_limit_ns=horizon_ns)


def _etcd(horizon_ns=None):
    cfg = etcd.EtcdConfig(hist_slots=256)
    ecfg = etcd.engine_config(cfg, time_limit_ns=horizon_ns or chip_smoke.ETCD_HORIZON_NS)
    return etcd.workload(cfg), ecfg


def _kafka(horizon_ns=None):
    wl, ecfg = chip_smoke.kafka_path()
    return wl, ecfg if horizon_ns is None else ecfg._replace(time_limit_ns=horizon_ns)


def _s3(horizon_ns=None):
    wl, ecfg = chip_smoke.s3_path()
    return wl, ecfg if horizon_ns is None else ecfg._replace(time_limit_ns=horizon_ns)


MODELS = {"raft": _raft, "etcd": _etcd, "kafka": _kafka, "s3": _s3}


def _envelope(lanes_per_candidate, horizon_ns=None):
    """The flagship under a ``FaultEnvelope`` over two candidates: the
    workload, engine config, seeds and per-lane params of the grid."""
    wl, ecfg, params = chip_smoke.envelope_flagship()
    if horizon_ns is not None:
        ecfg = ecfg._replace(time_limit_ns=horizon_ns)
    seeds = np.tile(np.arange(lanes_per_candidate, dtype=np.int64), len(params))
    return wl, ecfg, seeds, faults.grid_params(params, lanes_per_candidate)


# ---- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (drive captures its step graph only on CUDA)")
    return torch.device("cuda")


def _card_case(wl, ecfg, seeds, dev, params=None):
    """``drive`` against the eager loop from one initial state; returns
    ``drive``'s final."""
    state = core.init_sweep(wl, ecfg, seeds, device=dev, params=params)
    want, blocks = _eager_drive(wl, ecfg, state)
    got, steps, graph_steps, launches = _drive_counted(wl, ecfg, state)
    torch.cuda.synchronize()
    _assert_equal(got, want)
    assert steps == sum(blocks) > 0
    assert launches == steps
    assert graph_steps == _replayed(blocks)
    assert all(g.launches == K for g in core._GRAPHS.values())
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("model", sorted(MODELS))
def test_card_drive_equals_the_eager_step(card, model):
    wl, ecfg = MODELS[model]()
    lanes = 4096 if model in ("raft", "etcd") else 2048
    _card_case(wl, ecfg, np.arange(lanes, dtype=np.int64), card)


@pytest.mark.gpu
def test_card_drive_with_per_lane_params(card):
    wl, ecfg, seeds, params = _envelope(2048)
    _card_case(wl, ecfg, seeds, card, params=params)


@pytest.mark.gpu
def test_card_ragged_width_gets_its_own_capture(card):
    wl, ecfg = _raft()
    _card_case(wl, ecfg, np.arange(4096, dtype=np.int64), card)
    keys = set(core._GRAPHS)
    _card_case(wl, ecfg, np.arange(4096, 4096 + 1000, dtype=np.int64), card)
    new = set(core._GRAPHS) - keys
    assert len(new) == 1 and len(core._GRAPHS) <= core.GRAPH_CACHE


@pytest.mark.gpu
@pytest.mark.parametrize("max_steps", [K - 3, 100, 2 * core.CHECK_EVERY + 5])
def test_card_max_steps_no_multiple_of_the_graph(card, max_steps):
    wl, ecfg = _raft()
    _card_case(wl, ecfg._replace(max_steps=max_steps), np.arange(2048, dtype=np.int64), card)


@pytest.mark.gpu
def test_card_final_is_left_as_it_was_by_a_later_call(card):
    wl, ecfg = _etcd()
    first = _card_case(wl, ecfg, np.arange(4096, dtype=np.int64), card)
    kept = tree.map(torch.clone, first)
    # (an empty leaf has no memory to share)
    graph_ptrs = {leaf.untyped_storage().data_ptr() for g in core._GRAPHS.values()
                  for leaf in tree.leaves(g.static) if leaf.numel()}
    assert not any(leaf.untyped_storage().data_ptr() in graph_ptrs
                   for leaf in tree.leaves(first) if leaf.numel())
    _card_case(wl, ecfg, np.arange(4096, 8192, dtype=np.int64), card)
    _assert_equal(first, kept)


@pytest.mark.gpu
def test_card_workload_built_anew_replays_the_same_graph(card):
    cfg = raft.RaftConfig(num_nodes=5, crashes=1)
    ecfg = raft.engine_config(cfg, queue_capacity=chip_smoke.CAPACITY,
                              time_limit_ns=chip_smoke.HORIZON_NS)
    seeds = np.arange(2048, dtype=np.int64)
    captures = core.drive.captures
    _card_case(raft.workload(cfg), ecfg, seeds, card)
    _card_case(raft.workload(cfg), ecfg._replace(max_steps=1000), seeds + 2048, card)
    assert core.drive.captures - captures <= 1


# ---- on the CPU

def _cpu_state(model, lanes=8, horizon_ns=300_000_000):
    wl, ecfg = MODELS[model](horizon_ns)
    return wl, ecfg, core.init_sweep(wl, ecfg, np.arange(lanes, dtype=np.int64), device="cpu")


def test_cpu_drive_never_captures(monkeypatch):
    monkeypatch.setattr(core, "_GRAPHS", OrderedDict())
    wl, ecfg, state = _cpu_state("raft")
    want, blocks = _eager_drive(wl, ecfg, state)
    got, steps, graph_steps, launches = _drive_counted(wl, ecfg, state)
    _assert_equal(got, want)
    assert steps == sum(blocks) > 0
    assert graph_steps == 0 and launches == 0 and not core._GRAPHS


def _body_case(wl, ecfg, state):
    static = tree.map(torch.clone, state)
    core._steps_into(wl, ecfg, static, K)
    want = state
    for _ in range(K):
        want = core.step_batch(wl, ecfg, want, device="cpu")
    _assert_equal(static, want)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_cpu_graph_body_steps_in_place(model):
    wl, ecfg, state = _cpu_state(model)
    for _ in range(5):  # a state with events in flight
        state = core.step_batch(wl, ecfg, state, device="cpu")
    _body_case(wl, ecfg, state)


def test_cpu_graph_body_with_per_lane_params():
    wl, ecfg, seeds, params = _envelope(4, horizon_ns=300_000_000)
    _body_case(wl, ecfg, core.init_sweep(wl, ecfg, seeds, device="cpu", params=params))


def test_cpu_graph_body_refuses_a_changed_layout(monkeypatch):
    wl, ecfg, state = _cpu_state("raft")

    def widen(wl_, cfg_, s):
        return s._replace(ctr=s.ctr.to(torch.int64)), None, None

    monkeypatch.setattr(core, "_step", widen)
    with pytest.raises(ValueError, match="layout"):
        core._steps_into(wl, ecfg, state, K)


class _EagerGraph(core._StepGraph):
    """A stand-in step graph on the CPU: "capturing" keeps the body, and
    a replay runs it. Every stand-in is recorded, with its resets."""

    device_type = "cpu"
    made: list = []

    @staticmethod
    def _capture(body, device):
        # the card's capture takes in one pop-min launch a step
        cuda_queue.pop_min_decision.captured += K
        graph = SimpleNamespace(replay=body, resets=0)

        def reset():
            graph.resets += 1

        graph.reset = reset
        _EagerGraph.made.append(graph)
        return graph


@pytest.fixture
def eager_graph(monkeypatch):
    monkeypatch.setattr(core, "_StepGraph", _EagerGraph)
    monkeypatch.setattr(core, "_GRAPHS", OrderedDict())
    monkeypatch.setattr(_EagerGraph, "made", [])
    return _EagerGraph


@pytest.mark.parametrize("max_steps", [K - 3, 100, 200_000])
def test_cpu_rehearsal_of_drive_with_a_graph(eager_graph, max_steps):
    wl, ecfg, state = _cpu_state("raft", lanes=6)
    ecfg = ecfg._replace(max_steps=max_steps)
    want, blocks = _eager_drive(wl, ecfg, state)
    got, steps, graph_steps, launches = _drive_counted(wl, ecfg, state)
    _assert_equal(got, want)
    assert steps == sum(blocks)
    assert graph_steps == _replayed(blocks) == launches
    assert len(eager_graph.made) == (1 if max_steps >= K else 0)
    # the final is a copy: a second call on other seeds leaves it be
    kept = tree.map(torch.clone, got)
    other = core.init_sweep(wl, ecfg, np.arange(6, 12, dtype=np.int64), device="cpu")
    core.drive(wl, ecfg, other)
    _assert_equal(got, kept)
    assert len(eager_graph.made) == (1 if max_steps >= K else 0)  # reused


def test_cpu_rehearsal_cache_keeps_the_newest(eager_graph):
    wl, ecfg = _raft(300_000_000)
    ecfg = ecfg._replace(max_steps=K)
    widths = [3, 4, 5, 6, 7]
    for w in widths:
        state = core.init_sweep(wl, ecfg, np.arange(w, dtype=np.int64), device="cpu")
        want, _ = _eager_drive(wl, ecfg, state)
        _assert_equal(core.drive(wl, ecfg, state), want)
    assert len(core._GRAPHS) == core.GRAPH_CACHE
    assert [g.resets for g in eager_graph.made] == [1, 0, 0, 0, 0]
    # a hit moves its key to the newest end; a new width drops the oldest
    state = core.init_sweep(wl, ecfg, np.arange(4, dtype=np.int64), device="cpu")
    core.drive(wl, ecfg, state)
    assert len(eager_graph.made) == len(widths)
    state = core.init_sweep(wl, ecfg, np.arange(9, dtype=np.int64), device="cpu")
    core.drive(wl, ecfg, state)
    assert [g.resets for g in eager_graph.made] == [1, 0, 1, 0, 0, 0]
    # another config or workload is another key
    core.drive(wl, ecfg._replace(time_limit_ns=200_000_000), state)
    assert len(eager_graph.made) == len(widths) + 2


def test_cpu_rehearsal_equal_workloads_share_a_graph(eager_graph):
    cfg = raft.RaftConfig(num_nodes=3, crashes=1)
    ecfg = raft.engine_config(cfg, time_limit_ns=300_000_000, max_steps=K)
    seeds = np.arange(4, dtype=np.int64)
    for wl, e in [(raft.workload(cfg), ecfg), (raft.workload(cfg), ecfg._replace(max_steps=50))]:
        state = core.init_sweep(wl, e, seeds, device="cpu")
        want, _ = _eager_drive(wl, e, state)
        _assert_equal(core.drive(wl, e, state), want)
    assert len(eager_graph.made) == 1
    # another config is another workload
    other = cfg._replace(crashes=0)
    core.drive(raft.workload(other), raft.engine_config(other, max_steps=K),
               core.init_sweep(raft.workload(other), ecfg, seeds, device="cpu"))
    assert len(eager_graph.made) == 2


@pytest.mark.parametrize("per_step", [0, 2])
def test_cpu_rehearsal_capture_without_one_launch_a_step_raises(eager_graph, monkeypatch,
                                                                per_step):
    capture = eager_graph._capture

    def miscounted(body, device):
        graph = capture(body, device)
        cuda_queue.pop_min_decision.captured += (per_step - 1) * K
        return graph

    monkeypatch.setattr(eager_graph, "_capture", staticmethod(miscounted))
    wl, ecfg, state = _cpu_state("raft", lanes=4)
    captures = core.drive.captures
    with pytest.raises(RuntimeError, match="not one a step"):
        core.drive(wl, ecfg, state)
    assert not core._GRAPHS and core.drive.captures == captures
    assert [g.resets for g in eager_graph.made] == [1]


def test_cpu_rehearsal_count_compiles_counts_a_capture(eager_graph):
    wl, ecfg, state = _cpu_state("raft", lanes=4)
    with compiles.count_compiles() as first:
        core.drive(wl, ecfg, state)
    with compiles.count_compiles() as second:
        core.drive(wl, ecfg, state)
    assert (first.count, first.events) == (1, [("capture", "drive")])
    assert second.count == 0


@pytest.mark.parametrize("resumable", [False, True])
def test_cpu_rehearsal_sweep_million_captures_in_its_warm_up(eager_graph, monkeypatch, tmp_path,
                                                             resumable):
    # 24 seeds in chunks of 16: a ragged tail, padded to the chunk's width
    # by the plain loop and run at its own width by the resumable sweep
    from madsim_tpu_torch.scripts import sweep_million

    wl, ecfg = sweep_million._flagship()
    monkeypatch.setattr(sweep_million, "_flagship",
                        lambda: (wl, ecfg._replace(time_limit_ns=300_000_000)))
    monkeypatch.setenv("MADSIM_HB_SECONDS", "0")
    ckpt = str(tmp_path / "ck") if resumable else None
    out = sweep_million.sweep(None, 24, ckpt, 16, 0, torch.device("cpu"))
    assert out["compiles_in_timed_region"] == 0 and out["chunks_computed"] == 2
    assert len(eager_graph.made) == (2 if resumable else 1)


def test_step_count_on_the_eager_paths():
    wl, ecfg, state = _cpu_state("raft")
    step_batch, step = core.step_batch, core._step
    with core.StepCount() as count:
        want, blocks = _eager_drive(wl, ecfg, state)
        core.run_traced(wl, ecfg, 3, device="cpu")
    assert (core.step_batch, core._step) == (step_batch, step)
    _, traced = _eager_drive(wl, ecfg, core.init_sweep(wl, ecfg, [3], device="cpu"))
    assert count.batched == sum(blocks)
    assert count.steps - count.batched == sum(traced) > 0
    assert (count.launches, count.captures) == (0, 0)
    with pytest.raises(ZeroDivisionError), core.StepCount():
        1 / 0
    assert (core.step_batch, core._step) == (step_batch, step)


class _Collector:
    """A duck-typed ``telemetry=`` keeping every observed value."""

    tracer = None

    def __init__(self):
        self.observed = {}

    def observe(self, name, value, help="", **labels):
        self.observed.setdefault(name, []).append(value)

    def count(self, *args, **kwargs):
        pass

    gauge = event = event_mix = count


def _pipelined(chunk=16, n=48):
    wl, ecfg = _etcd(300_000_000)
    tel = _Collector()
    checkpoint.run_sweep_pipelined(wl, ecfg, np.arange(n, dtype=np.int64), etcd.sweep_summary,
                                   chunk_size=chunk, telemetry=tel, device="cpu")
    return tel.observed, n // chunk


def test_pipelined_sweep_observes_graph_steps_per_chunk():
    observed, chunks = _pipelined()
    assert observed["sweep_chunk_graph_steps"] == [0] * chunks
    assert len(observed["sweep_chunk_steps"]) == chunks


def test_pipelined_sweep_observes_replayed_steps(eager_graph):
    observed, chunks = _pipelined()
    steps, graphed = observed["sweep_chunk_steps"], observed["sweep_chunk_graph_steps"]
    assert len(graphed) == chunks and all(s > 0 for s in steps)
    # the chunks end before max_steps: every step of every chunk replayed
    assert graphed == steps
