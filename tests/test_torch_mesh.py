"""Port parity: the seed mesh (``madsim_tpu_torch.parallel``) and every
``mesh=`` route — the port's counterparts of ``tests/test_parallel.py``.

The port runs SPMD over ``torch.distributed``: each world size gets one
gloo world of spawned CPU ranks for the whole module
(``parallel.World``), and every rank runs the same job
(``tests/_torch_mesh_jobs.py``) and must return the same result. The
reference runs on the conftest's 8-device CPU mesh at the same device
count. Everything is exact: leaves (dtype too), summaries and report
bytes. World sizes 4 and 8 run under ``slow``.

Covered here: ``run_sweep_sharded`` for raft, etcd and kafka;
``run_sweep_sharded_chunked`` with a ragged tail and a batch padded to
mesh divisibility; the divisibility ``ValueError``; ``sharded_step``
against the reference's ``step_batch`` calls; ``screen_sweep(mesh=)``.
The checked sweep, the stream and the snapshot routes are in
``tests/test_torch_mesh_checked.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import madsim_tpu.engine  # noqa: F401  (the reference's int64 mode)
from madsim_tpu import parallel as rparallel
from madsim_tpu.engine import core as rcore
from madsim_tpu.engine.rng import prob_to_q32
from madsim_tpu.models import etcd as retcd
from madsim_tpu.models import kafka as rkafka
from madsim_tpu.models import raft as rraft
from madsim_tpu.oracle import screen as rscreen

import _torch_mesh_jobs as jobs
from _torch_parity import assert_leaves_equal, ref_leaves, ref_mesh, worlds

WORLDS = [1, 2, pytest.param(4, marks=pytest.mark.slow), pytest.param(8, marks=pytest.mark.slow)]
N = 16


world = pytest.fixture(scope="module")(worlds)


@functools.lru_cache(maxsize=None)
def ref_case(model):
    """The reference's (workload, engine config, summary) of a port case."""
    if model == "raft":
        cfg = rraft.RaftConfig(**jobs.RAFT, loss_q32=prob_to_q32(jobs.LOSS))
        return rraft.workload(cfg), rraft.engine_config(cfg, queue_capacity=32, **jobs.KW), \
            rraft.sweep_summary
    mod, fields = {
        "etcd": (retcd, {}), "kafka": (rkafka, {}),
        "etcd_hist": (retcd, jobs.ETCD_HIST), "etcd_stale": (retcd, jobs.STALE),
    }[model]
    cfg = (retcd.EtcdConfig if mod is retcd else rkafka.KafkaConfig)(**fields)
    return mod.workload(cfg), mod.engine_config(cfg, **jobs.KW), mod.sweep_summary


@functools.lru_cache(maxsize=None)
def ref_sweep(model, n=N):
    wl, ecfg, _ = ref_case(model)
    return ref_leaves(rcore.run_sweep(wl, ecfg, jnp.arange(n, dtype=jnp.int64)))


@pytest.mark.parametrize("model", ["raft", "etcd", "kafka"])
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_sweep_equals_reference(world, n, model):
    """Sharding changes no seed's execution: every leaf of the port's
    sharded sweep equals the reference's sweep (its sharded sweep equals
    its unsharded one, tests/test_parallel.py)."""
    got = world(n, jobs.sweep_leaves, model, N)
    assert_leaves_equal(ref_sweep(model), got, f"{model} sharded over {n}")


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_chunked_ragged_tail(world, n):
    """Chunking x sharding: 44 seeds as 16 + 16 + 12 (a ragged tail
    padded to mesh divisibility and trimmed) equal the reference's sweep
    leaf for leaf (its own chunked sharded sweep equals that,
    tests/test_parallel.py); a batch smaller than a chunk and not
    dividing the mesh is padded the same way."""
    wl, ecfg, _ = ref_case("raft")
    got = world(n, jobs.chunked_leaves, "raft", np.arange(44), 16 // n)
    assert_leaves_equal(ref_sweep("raft", 44), got, f"chunked over {n}")
    small = np.arange(100, 111)
    got = world(n, jobs.chunked_leaves, "raft", small, 16384)
    assert got[0].shape == (11,)
    want = rcore.run_sweep(wl, ecfg, jnp.asarray(small, jnp.int64))
    assert_leaves_equal(ref_leaves(want), got, f"small batch over {n}")


@pytest.mark.parametrize("n", [2, pytest.param(8, marks=pytest.mark.slow)])
def test_batch_must_divide_the_world(world, n):
    """A batch that does not divide the world size is refused with
    ``ValueError`` (the reference raises too), resumes included."""
    wl, ecfg, _ = ref_case("raft")
    with pytest.raises(Exception):
        rparallel.run_sweep_sharded(wl, ecfg, jnp.arange(n + 1, dtype=jnp.int64), ref_mesh(n))
    run_err, resume_err = world(n, jobs.refusals)
    assert run_err is not None and "divide" in run_err
    assert resume_err is not None and "divide" in resume_err


@functools.lru_cache(maxsize=None)
def _ref_step():
    wl, ecfg, _ = ref_case("raft")
    return jax.jit(lambda s: rcore.step_batch(wl, ecfg, s))


@functools.lru_cache(maxsize=None)
def ref_stepped(steps):
    """The reference's raft batch after ``steps`` jitted ``step_batch`` calls."""
    if steps == 0:
        wl, ecfg, _ = ref_case("raft")
        return rcore.init_sweep(wl, ecfg, jnp.arange(N, dtype=jnp.int64))
    return _ref_step()(ref_stepped(steps - 1))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("n", [1, 2])
def test_sharded_step_equals_reference_step_batch(world, n, steps):
    """``sharded_step(state, k)`` equals ``k`` calls of the reference's
    unsharded ``step_batch`` on every leaf (the reference's own
    ``sharded_step`` fails under this JAX, so it is not the yardstick),
    and its live count is the batch's."""
    state = ref_stepped(steps)
    got, live = world(n, jobs.stepped, N, steps)
    assert_leaves_equal(ref_leaves(state), got, f"{steps} sharded steps over {n}")
    assert live == int((~np.asarray(state.done)).sum()) > 0


@pytest.mark.parametrize("n", WORLDS)
def test_screen_on_mesh_equals_reference(world, n):
    """Each rank screens its own shard; the gathered mask equals the
    reference's unsharded screen of the same sweep."""
    wl, ecfg, _ = ref_case("etcd_stale")
    final = rcore.run_sweep(wl, ecfg, jnp.arange(32, dtype=jnp.int64))
    want = np.asarray(rscreen.screen_sweep(final, retcd.history_spec(), block=8))
    got = world(n, jobs.screened, 32, 8)
    assert want.any() and np.array_equal(got, want)
