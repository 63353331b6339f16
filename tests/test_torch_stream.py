"""Port parity: the streaming sweep (``madsim_tpu_torch.engine.stream``,
``device="cpu"``) — the port's counterparts of ``tests/test_stream.py``,
each held to the reference's ``stream_sweep`` on the same inputs: the
stream equals the chunked pipelined driver on raft, etcd and kafka; the
report is invariant to ``queue_order`` and ``reprioritize``; a v9
interrupt/resume is bit-identical (and its snapshot has the reference's
keys and dtypes, while a reference snapshot is refused); a warmed
multi-candidate stream counts 0 compiles; the canonical-bytes dedup key;
``feed`` segments and the feed guards; ``checked_sweep(driver="stream")``
report bytes; and ``mesh=`` refused."""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madsim_tpu.engine  # noqa: F401  (the reference's int64 mode, before its screens)
from madsim_tpu.engine import faults as rfaults
from madsim_tpu.engine import stream as rstream
from madsim_tpu.models import etcd as retcd
from madsim_tpu.models import kafka as rkafka
from madsim_tpu.models import raft as rraft
from madsim_tpu.oracle import screen as rscreen
from madsim_tpu_torch.engine import checkpoint as pcheckpoint
from madsim_tpu_torch.engine import compiles as pcompiles
from madsim_tpu_torch.engine import core as pcore
from madsim_tpu_torch.engine import faults as pfaults
from madsim_tpu_torch.engine import stream as pstream
from madsim_tpu_torch.models import etcd as petcd
from madsim_tpu_torch.models import kafka as pkafka
from madsim_tpu_torch.models import raft as praft
from madsim_tpu_torch.oracle import history as phist
from madsim_tpu_torch.oracle import screen as pscreen

from _torch_parity import port_cfg as port_raft_cfg
from _torch_parity import port_ecfg, port_spec

N = 16
SEEDS = np.arange(N, dtype=np.int64)
KW = dict(time_limit_ns=300_000_000, max_steps=4_000)
STREAM = dict(chunk_size=8, pool_size=8, round_steps=128)


@functools.lru_cache(maxsize=None)
def _case(model):
    """(reference workload, engine config, summary, port workload, engine
    config, summary) of the reference test's cases."""
    if model == "raft":
        rcfg = rraft.RaftConfig(num_nodes=3)
        return (rraft.workload(rcfg), rraft.engine_config(rcfg, **KW), rraft.sweep_summary,
                praft.workload(port_raft_cfg(rcfg)), port_ecfg(rraft.engine_config(rcfg, **KW)),
                praft.sweep_summary)
    if model == "etcd":
        rcfg = retcd.EtcdConfig(hist_slots=64, bug_stale_read=True)
        ecfg = retcd.engine_config(rcfg, **KW)
        return (retcd.workload(rcfg), ecfg, retcd.sweep_summary,
                petcd.workload(petcd.EtcdConfig(**rcfg._asdict())), port_ecfg(ecfg),
                petcd.sweep_summary)
    rcfg = rkafka.KafkaConfig()
    ecfg = rkafka.engine_config(rcfg, **KW)
    return (rkafka.workload(rcfg), ecfg, rkafka.sweep_summary,
            pkafka.workload(pkafka.KafkaConfig()), port_ecfg(ecfg), pkafka.sweep_summary)


@functools.lru_cache(maxsize=None)
def _reference_stream(model):
    rwl, recfg, rsum, *_ = _case(model)
    return rstream.stream_sweep(rwl, recfg, jnp.asarray(SEEDS), rsum, **STREAM)


def _port_stream(model, seeds=SEEDS, **kw):
    *_, pwl, pecfg, psum = _case(model)
    args = dict(STREAM, device="cpu")
    args.update(kw)
    return pstream.stream_sweep(pwl, pecfg, seeds, psum, **args)


@pytest.mark.parametrize("model", ["raft", "etcd", "kafka"])
def test_stream_matches_chunked_raft_etcd_kafka(model):
    *_, pwl, pecfg, psum = _case(model)
    chunked = pcheckpoint.run_sweep_pipelined(pwl, pecfg, SEEDS, psum, chunk_size=8,
                                              device="cpu")
    stats = {}
    streamed = _port_stream(model, stats=stats)
    assert streamed == chunked == _reference_stream(model)
    assert stats["lanes"] == 8 and stats["rounds"] > 0 and 0 < stats["occupancy_mean"] <= 1


def test_refill_schedule_invariance():
    base = _reference_stream("etcd")
    for perm_seed in (0, 3):
        order = np.random.default_rng(perm_seed).permutation(N)
        assert _port_stream("etcd", queue_order=order) == base


def test_reprioritize_changes_no_byte():
    calls = []

    def reverse(tail):
        calls.append(len(tail))
        return tail[::-1]

    assert _port_stream("etcd", reprioritize=reverse) == _reference_stream("etcd")
    assert calls and calls[0] == N - 8
    with pytest.raises(ValueError, match="permutation"):
        _port_stream("etcd", reprioritize=lambda tail: tail[:1])


def test_interrupt_resume_v9_bit_identity(tmp_path):
    path = str(tmp_path / "stream.npz")
    kw = dict(round_steps=64)
    partial = _port_stream("etcd", ckpt_path=path, stop_after_rounds=1, **kw)
    assert os.path.exists(path) and partial != _reference_stream("etcd")
    assert _port_stream("etcd", resume_from=path, **kw) == _reference_stream("etcd")


def test_v9_snapshot_has_the_reference_layout_and_is_refused_across(tmp_path):
    """The port's stream snapshot carries the reference's keys, dtypes
    and leaf shapes (and its ``__stream__`` tag's keys); a snapshot of the
    other package names another workload module, so it is refused."""
    rwl, recfg, rsum, *_ = _case("etcd")
    rpath, ppath = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    # item 0's budget of 5 events retires it in the first round of both
    # (the reference leaves at step 5, the port at 16), leaving pending
    # rows of an unfinished chunk
    budgets = np.where(SEEDS == 0, 5, KW["max_steps"])
    rstream.stream_sweep(rwl, recfg, jnp.asarray(SEEDS), rsum, ckpt_path=rpath,
                         stop_after_rounds=1, budgets=budgets, **STREAM)
    _port_stream("etcd", ckpt_path=ppath, stop_after_rounds=1, budgets=budgets)
    ref, port = np.load(rpath), np.load(ppath)
    assert sorted(port.files) == sorted(ref.files)
    for key in ref.files:
        assert port[key].dtype == ref[key].dtype, key
        if key.startswith("leaf_") or key == "__version__":
            assert port[key].shape == ref[key].shape, key
        if key.startswith("pend_"):
            assert port[key].shape[1:] == ref[key].shape[1:], key
    rmeta = json.loads(bytes(bytearray(ref["__stream__"])).decode())
    pmeta = json.loads(bytes(bytearray(port["__stream__"])).decode())
    assert sorted(pmeta) == sorted(rmeta)
    assert (pmeta["seeds_sha"], pmeta["order_sha"]) == (rmeta["seeds_sha"], rmeta["order_sha"])
    assert pmeta["fingerprint"] != rmeta["fingerprint"]
    # the port's round ends at its first quorum read (step 16), by when a
    # short seed may have retired too
    assert rmeta["items"] == [0] and pmeta["items"][0] == 0
    with pytest.raises(ValueError, match="fingerprint"):
        _port_stream("etcd", resume_from=rpath, budgets=budgets)


def test_warmed_multicandidate_stream_zero_compiles():
    """Lanes of different candidates share one pool; a warmed stream over
    fresh candidates counts no compile (builds, loads, dynamo graphs),
    and its totals equal the reference's."""
    base = rfaults.FaultSpec(crashes=1, crash_window_ns=400_000_000,
                             restart_lo_ns=50_000_000, restart_hi_ns=100_000_000)
    renv = rfaults.campaign_envelope(base, mutation_cap=2)
    rcfg = rraft.RaftConfig(num_nodes=3, faults=renv)
    recfg = rraft.engine_config(rcfg, **KW)
    pcfg = port_raft_cfg(rcfg)
    pwl, pecfg = praft.workload(pcfg), port_ecfg(recfg)
    s = 8

    def grid(specs, port=True):
        seeds = np.tile(np.arange(s, dtype=np.int64), len(specs))
        if not port:
            params = rfaults.grid_params(
                [rfaults.spec_to_params(sp, renv, rcfg.num_nodes) for sp in specs], s)
            return rstream.stream_sweep(rraft.workload(rcfg), recfg, seeds, rraft.sweep_summary,
                                        params=params, chunk_size=s, pool_size=2 * s,
                                        round_steps=128)
        params = pfaults.grid_params(
            [pfaults.spec_to_params(port_spec(sp), pcfg.faults, pcfg.num_nodes) for sp in specs],
            s)
        return pstream.stream_sweep(pwl, pecfg, seeds, praft.sweep_summary, params=params,
                                    chunk_size=s, pool_size=2 * s, round_steps=128,
                                    device="cpu")

    cands = [base, base._replace(crashes=2), base._replace(partitions=1)]
    grid(cands)  # warm
    fresh = [cands[1], cands[2], base._replace(crashes=0)]
    with pcompiles.count_compiles() as c:
        got = grid(fresh)
    assert c.count == 0, c.events
    assert got == grid(fresh, port=False)
    assert got["events_total"] > 0


def test_count_compiles_counts_kernel_builds_and_loads(monkeypatch):
    """The counter diffs ``cuda_build``'s caches over its region: a new
    build log and a new (or replaced) library count; a cached one does
    not."""
    from madsim_tpu_torch.engine import cuda_build

    monkeypatch.setitem(cuda_build._LIBS, "warm", object())
    with pcompiles.count_compiles() as c:
        monkeypatch.setitem(cuda_build.LOGS, "fresh", "nvcc log")
        monkeypatch.setitem(cuda_build._LIBS, "fresh", object())
        monkeypatch.setitem(cuda_build._LIBS, "warm", object())
    assert sorted(c.events) == [("build", "fresh"), ("load", "fresh"), ("load", "warm")]
    assert c.count == 3
    with pcompiles.count_compiles() as c:
        pass
    assert c.count == 0 and c.events == []


def test_refill_writes_rows_in_place():
    """``_put_`` writes a pool leaf in place, a uint32 leaf through its
    int32 bits, repeated indices with identical rows; a view is copied
    first, so the tensor it shares memory with stays as it was."""
    leaf = torch.zeros((4, 2), dtype=torch.uint32)
    rows = torch.tensor([[0xFFFFFFFF, 7], [0xFFFFFFFF, 7]], dtype=torch.int64).to(torch.uint32)
    idx = torch.tensor([2, 2])
    out = pstream._put_(leaf, idx, rows)
    assert out is leaf
    assert leaf.to(torch.int64).tolist() == [[0, 0], [0, 0], [0xFFFFFFFF, 7], [0, 0]]
    assert pstream._take(leaf, torch.tensor([2, 0])).to(torch.int64).tolist() == [
        [0xFFFFFFFF, 7], [0, 0]]
    base = torch.zeros(3, dtype=torch.int32)
    view = base.expand(2, 3)
    out = pstream._put_(view, torch.tensor([1]), torch.ones((1, 3), dtype=torch.int32))
    assert out.tolist() == [[0, 0, 0], [1, 1, 1]] and base.tolist() == [0, 0, 0]


def test_count_compiles_counts_dynamo_graphs():
    """The counter sees a ``torch.compile`` graph (eager backend, no
    compiler needed) and nothing once it is warm."""
    fn = torch.compile(lambda x: x * 2 + 1, backend="eager")
    x = torch.arange(4)
    with pcompiles.count_compiles() as c:
        fn(x)
    assert c.count >= 1
    with pcompiles.count_compiles() as c:
        fn(x)
    assert c.count == 0


def test_canonical_bytes_dedup_key():
    """The WGL dedup key: seed-free and invariant to absolute timestamps,
    sensitive to everything the checker reads."""
    from madsim_tpu.oracle import history as rhist

    def hist(mod, seed, t0):
        ops = (
            mod.Op(client=0, op=0, key=1, inp=7, out=7, invoke_ns=t0, complete_ns=t0 + 10,
                   opid=0),
            mod.Op(client=1, op=1, key=1, inp=0, out=7, invoke_ns=t0 + 5, complete_ns=-1,
                   opid=0),
        )
        return mod.History(seed=seed, ops=ops, overflow=False, rows=4)

    a, b = hist(phist, 3, 1_000), hist(phist, 9, 50_000)
    assert phist.history_bytes(a) != phist.history_bytes(b)
    assert phist.history_canonical_bytes(a) == phist.history_canonical_bytes(b)
    assert phist.history_canonical_bytes(a) == rhist.history_canonical_bytes(hist(rhist, 3, 1_000))
    c = a._replace(ops=(a.ops[0]._replace(out=8),) + a.ops[1:])
    assert phist.history_canonical_bytes(c) != phist.history_canonical_bytes(a)


def test_feed_segments_bit_identical_to_one_shot():
    segs = [np.arange(8, 12, dtype=np.int64), np.arange(12, 16, dtype=np.int64)]
    fed = _port_stream("raft", seeds=np.arange(8, dtype=np.int64), chunk_size=4,
                       feed=lambda: {"seeds": segs.pop(0)} if segs else None)
    # totals do not depend on the chunk size: the 8-seed chunks' reference
    assert fed == _reference_stream("raft")
    assert not segs


def test_feed_guards():
    seeds = SEEDS[:8]
    nothing = lambda: None  # noqa: E731
    with pytest.raises(ValueError, match="queue_order"):
        _port_stream("raft", seeds=seeds, feed=nothing, queue_order=np.arange(8)[::-1])
    with pytest.raises(ValueError, match="checkpointing"):
        _port_stream("raft", seeds=seeds, feed=nothing, ckpt_path="unused.npz",
                     stop_after_rounds=1)
    with pytest.raises(ValueError, match="multiple of"):
        _port_stream("raft", seeds=np.arange(7, dtype=np.int64), feed=nothing)
    with pytest.raises(ValueError, match="multiple of"):
        _port_stream("raft", seeds=seeds,
                     feed=iter([{"seeds": np.arange(8, 11, dtype=np.int64)}]).__next__)


def test_checked_sweep_stream_driver_report_bytes_equal():
    """``checked_sweep(driver="stream")`` against the reference's stream
    and the port's chunked driver: one report, byte for byte."""
    rwl, recfg, rsum, pwl, pecfg, psum = _case("etcd")
    want = rscreen.checked_sweep(rwl, recfg, SEEDS, retcd.history_spec(), rsum, chunk_size=8,
                                 driver="stream")
    for driver in ("stream", "chunked"):
        got = pscreen.checked_sweep(pwl, pecfg, SEEDS, petcd.history_spec(), psum,
                                    chunk_size=8, driver=driver, device="cpu")
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["hist_violations"] > 0
    with pytest.raises(ValueError, match="own snapshots"):
        pscreen.checked_sweep(pwl, pecfg, SEEDS, petcd.history_spec(), psum, chunk_size=8,
                              driver="stream", stop_after=1, device="cpu")


def test_mesh_and_the_default_device():
    # a one-rank mesh streams like no mesh (tests/test_torch_mesh_checked.py
    # runs the multi-rank route)
    from madsim_tpu_torch.parallel import seed_mesh

    assert _port_stream("raft", mesh=seed_mesh(device="cpu")) == _port_stream("raft")
    if not torch.cuda.is_available():
        *_, pwl, pecfg, psum = _case("raft")
        with pytest.raises(RuntimeError, match="CUDA"):
            pstream.stream_sweep(pwl, pecfg, SEEDS, psum, chunk_size=8)


def test_round_reads_its_quorum_every_16_steps():
    """``_round`` reads its quorum before every step, as the reference's
    device loop tests it, and leaves at the first step where it is met:
    a lane budget of 3 retires every lane after 3 events, and the round
    stops there, after 3 steps."""
    *_, pwl, pecfg, _ = _case("raft")
    state = pcore.init_sweep(pwl, pecfg, SEEDS[:4], device="cpu")
    budget = torch.full((4,), 3, dtype=torch.int32)
    calls = []
    step = pcore.step_batch

    def counted(*a, **k):
        calls.append(1)
        return step(*a, **k)

    pcore.step_batch = counted
    try:
        out = pstream._round(pwl, pecfg, 128, state, budget, stop_live=0)
    finally:
        pcore.step_batch = step
    assert len(calls) == 3
    assert out.ctr.tolist() == [3, 3, 3, 3] and not bool(out.done.any())
