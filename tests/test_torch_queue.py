"""Port parity: the batched event queue and the pop-min decision.

``madsim_tpu_torch.engine.queue`` against ``vmap`` of the reference's
per-seed queue ops, and the kernel's plain version
(``cuda_queue.pop_min_decision_ref``) against the Pallas kernel it
replaces (``pallas_queue.pop_min_pallas`` in interpret mode) and the XLA
pop decision — exact equality of value, dtype and shape."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.engine import core as rcore
from madsim_tpu.engine import pallas_queue as pq
from madsim_tpu.engine import queue as rq
from madsim_tpu.models import raft as rraft
from madsim_tpu_torch.engine import cuda_queue
from madsim_tpu_torch.engine import queue as pqueue

from _torch_parity import assert_leaves_equal

INV = int(rq.INVALID_TIME)


def _random_queue(rs, s, q, p, free_frac, time_hi):
    time = rs.randint(0, time_hi, size=(s, q)).astype(np.int64)
    time[rs.rand(s, q) < free_frac] = INV
    kind = rs.randint(0, 5, size=(s, q)).astype(np.int32)
    pay = rs.randint(-5, 1000, size=(s, q, p)).astype(np.int32)
    return time, kind, pay


def _ref_q(time, kind, pay):
    return rq.EventQueue(jnp.asarray(time), jnp.asarray(kind), jnp.asarray(pay))


def _port_q(time, kind, pay):
    return pqueue.EventQueue(*(torch.from_numpy(a.copy()) for a in (time, kind, pay)))


@pytest.mark.parametrize(
    "free_frac,time_hi",
    [(0.5, 10**9), (0.1, 4), (1.0, 4), (0.0, 10**6)],
    ids=["mixed", "ties", "empty", "full"],
)
def test_push_many_matches_reference(free_frac, time_hi):
    rs = np.random.RandomState(7)
    s, q, p, e = 96, 16, 8, 7
    queue = _random_queue(rs, s, q, p, free_frac, time_hi)
    times = rs.randint(0, 10**9, size=(s, e)).astype(np.int64)
    kinds = rs.randint(0, 5, size=(s, e)).astype(np.int32)
    pays = rs.randint(0, 100, size=(s, e, p)).astype(np.int32)
    enables = rs.rand(s, e) < 0.6
    ref_q, ref_ov = jax.vmap(rq.push_many)(
        _ref_q(*queue), jnp.asarray(times), jnp.asarray(kinds), jnp.asarray(pays),
        jnp.asarray(enables),
    )
    port_q, port_ov = pqueue.push_many(
        _port_q(*queue), torch.from_numpy(times), torch.from_numpy(kinds),
        torch.from_numpy(pays), torch.from_numpy(enables),
    )
    assert_leaves_equal(
        [np.asarray(a) for a in (*ref_q, ref_ov)],
        [a.numpy() for a in (*port_q, port_ov)],
        "push_many",
    )
    if free_frac == 0.0:
        assert port_ov.any()  # a full queue overflows: the case is not vacuous


@pytest.mark.parametrize(
    "free_frac,time_hi",
    [(0.5, 10**9), (0.2, 3), (1.0, 3)],
    ids=["mixed", "ties", "empty"],
)
def test_pop_min_and_size_match_reference(free_frac, time_hi):
    rs = np.random.RandomState(11)
    s, q, p = 128, 24, 8
    queue = _random_queue(rs, s, q, p, free_frac, time_hi)
    tie = rs.randint(0, 2**32, size=s, dtype=np.uint64).astype(np.uint32)
    enable = rs.rand(s) < 0.8
    ref = jax.vmap(lambda qq, en, t: rq.pop_min(qq, enable=en, tie_u32=t))(
        _ref_q(*queue), jnp.asarray(enable), jnp.asarray(tie)
    )
    port = pqueue.pop_min(
        _port_q(*queue), enable=torch.from_numpy(enable),
        tie_u32=torch.from_numpy(tie.astype(np.int64)),
    )
    ref_flat = [np.asarray(a) for a in (*ref[0], *ref[1:])]
    port_flat = [a.numpy() for a in (*port[0], *port[1:])]
    assert_leaves_equal(ref_flat, port_flat, "pop_min")
    assert_leaves_equal(
        [np.asarray(jax.vmap(rq.size)(ref[0]))], [pqueue.size(port[0]).numpy()], "size"
    )


@pytest.fixture(scope="module")
def raft_queues():
    """The 256-seed flagship raft queues after 12 events (the batch of
    tests/test_pallas.py) — real deadlines with real ties."""
    cfg = rraft.RaftConfig(num_nodes=5, crashes=1)
    ecfg = rraft.engine_config(cfg)
    wl = rraft.workload(cfg)
    state = jax.jit(partial(rcore.init_sweep, wl, ecfg))(jnp.arange(256, dtype=jnp.int64))
    step = jax.jit(partial(rcore.step_batch, wl, ecfg))
    for _ in range(12):
        state = step(state)
    return state.queue


def _plain(q, tie):
    return cuda_queue.pop_min_decision_ref(
        torch.from_numpy(np.array(q.time)), torch.from_numpy(np.array(tie))
    )


def test_plain_pop_min_matches_pallas_kernel_on_raft_queues(raft_queues):
    tie = jax.random.bits(jax.random.key(3), (256,), dtype=jnp.uint32)
    sp, fp = pq.pop_min_pallas(raft_queues, tie, interpret=True)
    sx, fx = pq.pop_min_xla(raft_queues, tie)
    slot, found = _plain(raft_queues, tie)
    assert_leaves_equal(
        [np.asarray(sp), np.asarray(fp)], [slot.numpy(), found.numpy()], "vs pallas"
    )
    assert_leaves_equal(
        [np.asarray(sx), np.asarray(fx)], [slot.numpy(), found.numpy()], "vs xla"
    )
    assert bool(found.all())


@pytest.mark.parametrize("capacity", [58, 64, 128])
def test_plain_pop_min_on_empty_queues(capacity):
    """On an empty queue the slot is still defined (the minimal-priority
    slot) and must match the engine's pop decision: pop_min reads the
    payload at that slot without the found mask.

    The Pallas kernel pads Q to 128 lanes with INVALID deadlines, so on
    an EMPTY queue a padding lane (slot >= Q) can win the tie-break where
    the XLA path picks an in-range slot; found agrees either way. The
    port follows the engine's (XLA) decision exactly, and equals the
    Pallas kernel wherever its winner is a real slot — everywhere at
    Q = 128, which needs no padding."""
    empty = jax.vmap(lambda _: rq.make(capacity, 8))(jnp.arange(128))
    tie = jax.random.bits(jax.random.key(5), (128,), dtype=jnp.uint32)
    sp, fp = pq.pop_min_pallas(empty, tie, interpret=True)
    sx, fx = pq.pop_min_xla(empty, tie)
    slot, found = _plain(empty, tie)
    assert_leaves_equal(
        [np.asarray(sx), np.asarray(fx)], [slot.numpy(), found.numpy()], "vs xla"
    )
    np.testing.assert_array_equal(found.numpy(), np.asarray(fp))
    assert not bool(found.any())
    real = np.asarray(sp) < capacity
    np.testing.assert_array_equal(slot.numpy()[real], np.asarray(sp)[real])
    if capacity == 128:
        assert real.all()


def test_cpu_wrapper_takes_the_plain_path_and_counts_no_launch():
    rs = np.random.RandomState(3)
    time = torch.from_numpy(_random_queue(rs, 64, 64, 1, 0.3, 5)[0])
    tie = torch.from_numpy(rs.randint(0, 2**32, size=64).astype(np.int64))
    before = cuda_queue.pop_min_decision.launches
    slot, found = cuda_queue.pop_min_decision(time, tie)
    ref_slot, ref_found = cuda_queue.pop_min_decision_ref(time, tie)
    assert torch.equal(slot, ref_slot) and torch.equal(found, ref_found)
    assert slot.dtype == torch.int32 and found.dtype == torch.bool
    assert cuda_queue.pop_min_decision.launches == before

