"""Port parity: the batched indexing helpers (``engine/ops.py``), the
link-state clog helpers (``engine/net.py``) and single-event ``push``
against ``vmap`` of the reference's per-seed functions — exact equality
of value, dtype and shape, including the reference's out-of-range rule
(a read outside the axis gives 0, a write outside it does nothing)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.engine import net as rnet
from madsim_tpu.engine import ops as rops
from madsim_tpu.engine import queue as rq
from madsim_tpu_torch.engine import core as pcore
from madsim_tpu_torch.engine import net as pnet
from madsim_tpu_torch.engine import ops as pops
from madsim_tpu_torch.engine import queue as pqueue

from _torch_parity import assert_leaves_equal, ref_leaves

S, N, L = 64, 5, 7
RS = np.random.RandomState(21)
IDX = RS.randint(-2, N + 2, size=S).astype(np.int32)  # includes out of range
JDX = RS.randint(-1, L + 1, size=S).astype(np.int32)
EN = RS.rand(S) < 0.7

ARRAYS = {
    "int32": RS.randint(-100, 100, size=(S, N, L)).astype(np.int32),
    "int64": RS.randint(-(10**12), 10**12, size=(S, N, L)).astype(np.int64),
    "bool": RS.rand(S, N, L) < 0.5,
    "uint32": RS.randint(0, 2**32, size=(S, N, L), dtype=np.uint64).astype(np.uint32),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("dtype", sorted(ARRAYS))
def test_get_and_set_helpers_match_reference(dtype):
    a = ARRAYS[dtype]
    row_val = a[:, 0, :]
    val = a[:, 1, 2]
    ref = [
        jax.vmap(rops.get1)(_j(a), _j(IDX)),
        jax.vmap(rops.get2)(_j(a), _j(IDX), _j(JDX)),
        jax.vmap(rops.set1)(_j(a), _j(IDX), _j(row_val), _j(EN)),
        jax.vmap(lambda x, i, e: rops.set1(x, i, 1, e))(_j(a), _j(IDX), _j(EN)),
        jax.vmap(rops.set2)(_j(a), _j(IDX), _j(JDX), _j(val), _j(EN)),
        jax.vmap(lambda x, i, j, v: rops.set2(x, i, j, v))(_j(a), _j(IDX), _j(JDX), _j(val)),
        jax.vmap(rops.onehot, in_axes=(0, None))(_j(IDX), N),
    ]
    port = [
        pops.get1(_t(a), _t(IDX)),
        pops.get2(_t(a), _t(IDX), _t(JDX)),
        pops.set1(_t(a), _t(IDX), _t(row_val), _t(EN)),
        pops.set1(_t(a), _t(IDX), 1, _t(EN)),
        pops.set2(_t(a), _t(IDX), _t(JDX), _t(val), _t(EN)),
        pops.set2(_t(a), _t(IDX), _t(JDX), _t(val)),
        pops.onehot(_t(IDX), N),
    ]
    assert_leaves_equal([np.asarray(r) for r in ref], [p.numpy() for p in port], dtype)


@pytest.mark.parametrize("dtype", ["int32", "int64", "bool"])
def test_gather_helpers_match_reference(dtype):
    a = ARRAYS[dtype]
    idxs = RS.randint(-1, L + 1, size=(S, 4)).astype(np.int32)
    ref = [
        jax.vmap(rops.geti)(_j(a[:, 0, :]), _j(idxs)),
        jax.vmap(rops.getrow_i)(_j(a), _j(IDX), _j(idxs)),
    ]
    port = [pops.geti(_t(a[:, 0, :]), _t(idxs)), pops.getrow_i(_t(a), _t(IDX), _t(idxs))]
    assert_leaves_equal([np.asarray(r) for r in ref], [p.numpy() for p in port], dtype)


def test_clog_helpers_match_reference():
    src = RS.randint(0, N, size=S).astype(np.int32)
    dst = RS.randint(0, N, size=S).astype(np.int32)
    r = jax.vmap(lambda _: rnet.make(N, 7, 2, 9, 3))(jnp.arange(S))
    p = pnet.make(S, N, 7, 2, 9, 3)
    steps = [
        (rnet.clog_node, pnet.clog_node, (src,)),
        (rnet.clog_link, pnet.clog_link, (dst, src)),
        (rnet.unclog_node, pnet.unclog_node, (dst,)),
        (rnet.unclog_link, pnet.unclog_link, (src, dst)),
    ]
    for rf, pf, args in steps:
        r = jax.vmap(rf)(r, *(_j(x) for x in args))
        p = pf(p, *(_t(x) for x in args))
        assert_leaves_equal(ref_leaves(r), [x.numpy() for x in p], rf.__name__)
    assert bool(p.clog.any())


def test_push_matches_reference_including_overflow():
    q = 6
    time = RS.randint(0, 100, size=(S, q)).astype(np.int64)
    time[RS.rand(S, q) < 0.4] = int(rq.INVALID_TIME)
    time[:4] = 7  # full queues overflow
    kind = RS.randint(0, 5, size=(S, q)).astype(np.int32)
    pay = RS.randint(0, 9, size=(S, q, 3)).astype(np.int32)
    t_new = RS.randint(0, 100, size=S).astype(np.int64)
    k_new = RS.randint(0, 5, size=S).astype(np.int32)
    p_new = RS.randint(0, 9, size=(S, 3)).astype(np.int32)
    ref_q, ref_ov = jax.vmap(rq.push)(
        rq.EventQueue(_j(time), _j(kind), _j(pay)), _j(t_new), _j(k_new), _j(p_new), _j(EN)
    )
    port_q, port_ov = pqueue.push(
        pqueue.EventQueue(_t(time), _t(kind), _t(pay)), _t(t_new), _t(k_new), _t(p_new),
        _t(EN),
    )
    assert_leaves_equal(
        [np.asarray(x) for x in (*ref_q, ref_ov)], [x.numpy() for x in (*port_q, port_ov)],
        "push",
    )
    assert bool(port_ov[:4].any())


def test_no_emits_shapes():
    e = pcore.no_emits(3, 7, 8, "cpu")
    assert [tuple(x.shape) for x in e] == [(3, 7), (3, 7), (3, 7, 8), (3, 7)]
    assert [x.dtype for x in e] == [torch.int64, torch.int32, torch.int32, torch.bool]
    assert not bool(e.enables.any())
