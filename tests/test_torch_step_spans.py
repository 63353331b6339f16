"""The port's step phase spans and the pipelined driver's per-chunk
counters, on the CPU (the port alone: nothing here is compared with the
reference, so JAX is not imported).

Under ``torch.profiler`` one ``step_batch`` inside an outer range gives
the six ``step.*`` ranges as that range's direct children, in order, with
every aten op of the step under one of them; on every path through the
step (``step_batch``, ``step_one``, ``run_traced``). With the profiler
off the step enters no range, and its states are bit-equal with the
profiler on and off. A pipelined checked sweep with a telemetry handle
observes ``sweep_screen_seconds``, ``sweep_chunk_steps`` and
``sweep_chunk_events`` once per chunk: the steps are the chunk's
``step_batch`` calls, the events the sum of its final state's ``ctr``
over the chunk's real lanes. A sweep with no screen records no screen
time.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from madsim_tpu_torch.engine import core, tree
from madsim_tpu_torch.models import etcd, raft
from madsim_tpu_torch.oracle import screen

PHASES = ["step.draws", "step.pop", "step.handler", "step.push", "step.planes", "step.select"]
LANES = 8
WARM = 12


def _case(model):
    if model == "raft":
        cfg = raft.RaftConfig(num_nodes=5, crashes=1)
        return raft.workload(cfg), raft.engine_config(cfg, queue_capacity=64,
                                                      time_limit_ns=3_000_000_000)
    cfg = etcd.EtcdConfig(hist_slots=48)
    return etcd.workload(cfg), etcd.engine_config(cfg, time_limit_ns=1_000_000_000)


def _state(model):
    wl, ecfg = _case(model)
    s = core.init_sweep(wl, ecfg, np.arange(LANES, dtype=np.int64), device="cpu")
    for _ in range(WARM):
        s = core.step_batch(wl, ecfg, s, device="cpu")
    return wl, ecfg, s


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b)))


def _ancestors(e):
    p = e.cpu_parent
    while p is not None:
        yield p
        p = p.cpu_parent


@pytest.mark.parametrize("model", ["raft", "etcd"])
def test_phases_tile_one_step(model):
    wl, ecfg, s = _state(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("step_batch"):
            core.step_batch(wl, ecfg, s, device="cpu")
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    children = sorted((e for e in events if e.cpu_parent is not None
                       and e.cpu_parent.name == "step_batch"), key=lambda e: e.time_range.start)
    assert [e.name for e in children] == PHASES
    ops = [e for e in events if e.name.startswith("aten::")
           and any(a.name == "step_batch" for a in _ancestors(e))]
    assert ops
    for op in ops:
        inside = [a.name for a in _ancestors(op) if a.name in PHASES]
        assert len(inside) == 1, (op.name, inside)
    # the handler's phase holds the model's ops: most of the step's
    handler = sum(1 for op in ops if "step.handler" in [a.name for a in _ancestors(op)])
    assert handler > len(ops) / 3


def test_every_path_through_the_step_has_the_ranges():
    wl, ecfg, s = _state("raft")
    one = tree.map(lambda a: a[0], s)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        core.step_one(wl, ecfg, one)
        core.run_traced(wl, ecfg._replace(max_steps=3), 3, device="cpu")
    names = [e.name for e in prof.events() if e.name.startswith("step.")]
    assert names == PHASES * 4


def test_no_range_and_equal_states_with_the_profiler_off(monkeypatch):
    wl, ecfg, s = _state("etcd")
    entered = []
    real = core._RecordFunctionFast

    def counted(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(core, "_RecordFunctionFast", counted)
    off = s
    for _ in range(4):
        off = core.step_batch(wl, ecfg, off, device="cpu")
    assert entered == []
    on = s
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            on = core.step_batch(wl, ecfg, on, device="cpu")
    assert entered == PHASES * 4
    assert _equal(on, off)
    assert not torch.autograd.profiler._is_profiler_enabled


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


def test_pipelined_checked_sweep_observes_each_chunk(monkeypatch):
    wl, ecfg = _case("etcd")
    seeds = np.arange(96, dtype=np.int64)
    chunk = 32
    calls, per_chunk = [0], []
    step_batch, run_sweep = core.step_batch, core.run_sweep

    def counted_batch(*args, **kwargs):
        calls[0] += 1
        return step_batch(*args, **kwargs)

    def counted_sweep(*args, **kwargs):
        before = calls[0]
        final = run_sweep(*args, **kwargs)
        per_chunk.append((calls[0] - before, int(final.ctr.sum(dtype=torch.int64))))
        return final

    monkeypatch.setattr(core, "step_batch", counted_batch)
    monkeypatch.setattr(core, "run_sweep", counted_sweep)
    tel = _Collector()
    report = screen.checked_sweep(wl, ecfg, seeds, etcd.history_spec(), etcd.sweep_summary,
                                  chunk_size=chunk, telemetry=tel, device="cpu")
    assert report["hist_screened"] == len(seeds)
    chunks = len(seeds) // chunk
    assert len(per_chunk) == chunks
    assert tel.observed["sweep_chunk_steps"] == [n for n, _ in per_chunk]
    assert tel.observed["sweep_chunk_events"] == [e for _, e in per_chunk]
    assert all(n > 0 for n, _ in per_chunk)
    screen_s = tel.observed["sweep_screen_seconds"]
    assert len(screen_s) == chunks and all(0.0 < t < 60.0 for t in screen_s)
    assert len(tel.observed["sweep_chunk_seconds"]) == chunks


def test_pipelined_sweep_without_telemetry_reads_no_counter(monkeypatch):
    """With no handle the driver starts no timer and reads no sum."""
    from madsim_tpu_torch.engine import checkpoint

    def refuse(*args, **kwargs):
        raise AssertionError("a screen timer without telemetry")

    monkeypatch.setattr(checkpoint, "_ScreenTimer", refuse)
    wl, ecfg = _case("etcd")
    report = screen.checked_sweep(wl, ecfg, np.arange(16, dtype=np.int64), etcd.history_spec(),
                                  etcd.sweep_summary, chunk_size=16, device="cpu")
    assert report["hist_screened"] == 16


def test_pipelined_sweep_counts_real_lanes_and_times_no_absent_screen(monkeypatch):
    """Padded chunks: the events are the real lanes' ``ctr`` sum; with no
    screen no timer starts and no screen time is observed."""
    from madsim_tpu_torch.engine import checkpoint

    def refuse(*args, **kwargs):
        raise AssertionError("a screen timer without a screen")

    monkeypatch.setattr(checkpoint, "_ScreenTimer", refuse)
    wl, ecfg = _case("raft")
    seeds = np.arange(20, dtype=np.int64)
    ks, finals = [16, 4], []

    def run_chunk(chunk):
        final = core.run_sweep(wl, ecfg, chunk, device="cpu")
        finals.append(final)
        return final

    tel = _Collector()
    checkpoint.run_sweep_pipelined(wl, ecfg, seeds, raft.sweep_summary, chunk_size=16,
                                   pad_multiple=8, run_chunk=run_chunk, telemetry=tel,
                                   device="cpu")
    assert [int(f.ctr.shape[0]) for f in finals] == [16, 8]
    want = [int(f.ctr[:k].sum(dtype=torch.int64)) for f, k in zip(finals, ks)]
    assert tel.observed["sweep_chunk_events"] == want
    assert want[1] < int(finals[1].ctr.sum(dtype=torch.int64))
    assert len(tel.observed["sweep_chunk_steps"]) == 2
    assert "sweep_screen_seconds" not in tel.observed


def test_profile_step_reads_one_row_per_phase():
    """``profile_step``'s reading of a profile: a row per phase with its
    host time, and the step's row (no device operations on the CPU)."""
    from madsim_tpu_torch import profile_step

    wl, ecfg, s = _state("raft")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            s = core.step_batch(wl, ecfg, s, device="cpu")
    rows = profile_step.phases(prof.events(), 3)
    assert [r["phase"] for r in rows] == PHASES + ["step"]
    assert all(r["host_ms"] > 0 and r["device_ms"] == 0 and r["idle_ms"] == 0
               for r in rows[:-1])
    assert rows[-1]["ops"] == 0 and rows[-1]["mirrored_phase_events"] == 0
