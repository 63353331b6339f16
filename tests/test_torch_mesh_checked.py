"""Port parity: the checked sweep, the stream and the snapshots on the
seed mesh — ``checked_sweep(mesh=)``, ``stream_sweep(mesh=)`` and
``run_sweep_sharded_pipelined(resume_from=)`` of
``madsim_tpu_torch``, the counterparts of ``tests/test_parallel.py``'s
matrix and portability tests.

As in ``tests/test_torch_mesh.py``, each world size gets one gloo world
of spawned CPU ranks for the module, every rank must return the same
result, and the reference runs on the conftest's CPU mesh at the same
device count. Report bytes are compared exactly. World sizes 4 and 8
run under ``slow``."""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest

import madsim_tpu.engine  # noqa: F401  (the reference's int64 mode)
from madsim_tpu import parallel as rparallel
from madsim_tpu.engine import checkpoint as rcheckpoint
from madsim_tpu.engine import core as rcore
from madsim_tpu.engine import stream as rstream
from madsim_tpu.models import etcd as retcd
from madsim_tpu.oracle import screen as rscreen
from madsim_tpu_torch.engine import checkpoint as pcheckpoint
from madsim_tpu_torch.models import etcd as petcd
from madsim_tpu_torch.oracle import screen as pscreen

import _torch_mesh_jobs as jobs
from _torch_parity import assert_leaves_equal, ref_leaves, ref_mesh, worlds

WORLDS = [1, 2, pytest.param(4, marks=pytest.mark.slow), pytest.param(8, marks=pytest.mark.slow)]

world = pytest.fixture(scope="module")(worlds)


@functools.lru_cache(maxsize=None)
def ref_case(model):
    """The reference's (workload, engine config, summary) of an etcd case."""
    cfg = retcd.EtcdConfig(**{"etcd_hist": jobs.ETCD_HIST, "etcd_stale": jobs.STALE}[model])
    return retcd.workload(cfg), retcd.engine_config(cfg, **jobs.KW), retcd.sweep_summary


CHECKED_SEEDS, CPD = 32, 8


@functools.lru_cache(maxsize=None)
def ref_checked(n_dev):
    wl, ecfg, summarize = ref_case("etcd_stale")
    return json.dumps(rscreen.checked_sweep(
        wl, ecfg, jnp.arange(CHECKED_SEEDS, dtype=jnp.int64), retcd.history_spec(),
        summarize, mesh=ref_mesh(n_dev), chunk_per_device=CPD), sort_keys=True)


@pytest.mark.parametrize("n", WORLDS)
def test_checked_sweep_mesh_report_bytes(world, n):
    """``checked_sweep(mesh=)`` report bytes equal the reference's at the
    same device count, the unsharded port's at the same global chunk,
    and the one-rank world's (the report is invariant across world
    sizes); ``driver="stream"`` on the mesh gives the same bytes."""
    got = world(n, jobs.checked, CHECKED_SEEDS, CPD)
    assert got == ref_checked(n)
    assert json.loads(got)["hist_violations"] > 0
    wl, ecfg, summarize = jobs.port_case("etcd_stale")
    plain = pscreen.checked_sweep(
        wl, ecfg, np.arange(CHECKED_SEEDS), petcd.history_spec(), summarize,
        chunk_size=CPD * n, device="cpu")
    assert got == json.dumps(plain, sort_keys=True)
    assert ref_checked(1) == got  # invariant across world sizes
    assert world(n, jobs.checked, CHECKED_SEEDS, CPD, "stream") == got


@pytest.mark.parametrize("n", [1, 2])
def test_host_phase_runs_once_on_rank_0(world, n):
    """The sharded pipelined driver runs a chunk's host phase on rank 0
    only and broadcasts its verdict: rank 0 calls ``host_work`` once per
    chunk, the other ranks never, and the report is the reference's."""
    report, calls = world(n, jobs.host_phase_calls, CHECKED_SEEDS, CPD)
    assert report == ref_checked(n)
    assert calls == [CHECKED_SEEDS // (CPD * n)] + [0] * (n - 1)


@pytest.mark.parametrize("n", WORLDS)
def test_stream_mesh_equals_chunked(world, n, tmp_path):
    """``stream_sweep(mesh=)`` (the pool sharded over the ranks, the
    retirements and refills derived alike on every rank) equals the
    reference's chunked pipelined totals over the same chunks, and so
    does a mesh stream stopped after 2 rounds and resumed."""
    wl, ecfg, summarize = ref_case("etcd_stale")
    want = rcheckpoint.run_sweep_pipelined(
        wl, ecfg, jnp.arange(CHECKED_SEEDS, dtype=jnp.int64), summarize, chunk_size=16)
    got, resumed = world(n, jobs.streamed, CHECKED_SEEDS, 16, 8, str(tmp_path / "s.npz"))
    assert got == json.dumps(want, sort_keys=True) == resumed
    ref_stream = rstream.stream_sweep(
        wl, ecfg, jnp.arange(CHECKED_SEEDS, dtype=jnp.int64), summarize, chunk_size=16,
        pool_size=8, round_steps=64)
    assert got == json.dumps(ref_stream, sort_keys=True)


def test_mesh_snapshot_crosses_packages_and_world_sizes(world, tmp_path):
    """A sweep interrupted mid-chunk on 2 ranks and saved with its mesh
    layout equals the reference's interrupted on 2 devices; the port
    resumes the reference's snapshot on 1 rank and back on 2, and the
    reference resumes the port's, each to totals equal to the straight
    run's."""
    wl, ecfg, summarize = ref_case("etcd_hist")
    short = ecfg._replace(max_steps=60)
    seeds = jnp.arange(CHECKED_SEEDS, dtype=jnp.int64)
    mesh2 = ref_mesh(2)
    rpath, ppath = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    rpartial = rparallel.run_sweep_sharded(wl, short, seeds[:2 * CPD], mesh2)
    rlayout = rparallel.mesh_layout(mesh2, CPD)
    rcheckpoint.save_sweep(rpartial, rpath, inflight={"lo": 0, "k": 2 * CPD},
                           mesh_layout=rlayout)
    ppartial = world(2, jobs.interrupted, CHECKED_SEEDS, CPD, ppath)
    assert_leaves_equal(ref_leaves(rpartial), ppartial, "interrupted on 2")
    assert pcheckpoint.load_mesh_layout(ppath) == rlayout

    straight = rparallel.run_sweep_sharded_pipelined(
        wl, ecfg, seeds, summarize, mesh=ref_mesh(1), chunk_size=rlayout["chunk_size"])
    want = json.dumps(straight, sort_keys=True)
    for n in (1, 2):
        got = world(n, jobs.resumed, CHECKED_SEEDS, rpath)
        assert got["layout"] == rlayout
        assert got["straight"] == want and got["resumed"] == want, f"resumed on {n}"
    restored = rcheckpoint.load_sweep(
        ppath, rcore.init_sweep(wl, ecfg, jnp.arange(2 * CPD, dtype=jnp.int64)))
    resumed = rparallel.run_sweep_sharded_pipelined(
        wl, ecfg, seeds, summarize, mesh=ref_mesh(1), chunk_size=rlayout["chunk_size"],
        resume_from=(restored, rcheckpoint.load_inflight(ppath)))
    assert json.dumps(resumed, sort_keys=True) == want


# -- the 4,096-seed matrix of tests/test_parallel.py:168-218 (slow) ------------

MATRIX_SEEDS = 4096


@pytest.mark.slow
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_matrix_per_seed_state_equality(world, n):
    """4,096 seeds of the reference test's raft config (1 s, 8,000 steps)
    at 1,024 lanes per rank: every leaf equals the reference's unsharded
    sweep."""
    from madsim_tpu.engine.rng import prob_to_q32
    from madsim_tpu.models import raft as rraft

    cfg = rraft.RaftConfig(**jobs.RAFT, loss_q32=prob_to_q32(jobs.LOSS))
    ecfg = rraft.engine_config(cfg, queue_capacity=32, time_limit_ns=1_000_000_000,
                               max_steps=8_000)
    want = rcore.run_sweep(rraft.workload(cfg), ecfg, jnp.arange(MATRIX_SEEDS, dtype=jnp.int64))
    got = world(n, jobs.matrix_leaves, MATRIX_SEEDS, 1024)
    assert_leaves_equal(ref_leaves(want), got, f"4,096 seeds over {n}")


@functools.lru_cache(maxsize=None)
def ref_matrix_report():
    cfg = retcd.EtcdConfig(hist_slots=128)
    ecfg = retcd.engine_config(cfg, time_limit_ns=500_000_000, max_steps=6_000)
    return json.dumps(rscreen.checked_sweep(
        retcd.workload(cfg), ecfg, jnp.arange(MATRIX_SEEDS, dtype=jnp.int64),
        retcd.history_spec(), retcd.sweep_summary, chunk_size=1024), sort_keys=True)


@pytest.mark.slow
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_matrix_checked_sweep_report_bytes(world, n):
    """The reference test's checked sweep (etcd, 128 history rows, 500 ms)
    over 4,096 seeds at 512 lanes per rank equals the reference's
    unsharded report at chunks of 1,024."""
    assert world(n, jobs.matrix_checked, MATRIX_SEEDS, 512) == ref_matrix_report()
