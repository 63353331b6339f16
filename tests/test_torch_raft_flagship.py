"""Port parity on the 5-node flagship (``RaftConfig(num_nodes=5,
crashes=1)``, queue 64) at a short horizon, and the state carried across
from the reference with ``state_io`` — exact equality of every leaf."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from madsim_tpu.engine import core as rcore
from madsim_tpu.models import raft as rraft
from madsim_tpu_torch.engine import core as pcore
from madsim_tpu_torch.engine import state_io
from madsim_tpu_torch.models import raft as praft

from _torch_parity import assert_leaves_equal, port_cfg, port_ecfg, ref_leaves

SEEDS = np.concatenate([np.arange(60), [2**32, 2**32 + 1, 2**40 + 7, 123456789]]).astype(
    np.int64
)
CFG = rraft.RaftConfig(num_nodes=5, crashes=1)
ECFG = rraft.engine_config(CFG, queue_capacity=64, time_limit_ns=1_000_000_000,
                           max_steps=200_000)


@pytest.fixture(scope="module")
def flagship():
    ref = rcore.run_sweep(rraft.workload(CFG), ECFG, jnp.asarray(SEEDS))
    port = pcore.run_sweep(praft.workload(port_cfg(CFG)), port_ecfg(ECFG), SEEDS,
                           device="cpu")
    return ref, port


def test_flagship_every_leaf_equal(flagship):
    ref, port = flagship
    assert_leaves_equal(ref_leaves(ref), state_io.to_numpy_leaves(port), "flagship")


def test_flagship_summary_equal(flagship):
    ref, port = flagship
    psum = praft.sweep_summary(port)
    assert psum == rraft.sweep_summary(ref)
    assert psum["elections_total"] > 0 and psum["msgs_delivered"] > 0


@pytest.mark.parametrize("k", [0, 40])
def test_step_from_reference_state_via_state_io(k):
    """Start the port from the reference's state after ``k`` events and
    compare one ``step_batch`` (and the leaves' round trip)."""
    wl = rraft.workload(CFG)
    state = jax.jit(partial(rcore.init_sweep, wl, ECFG))(jnp.asarray(SEEDS))
    step = jax.jit(partial(rcore.step_batch, wl, ECFG))
    for _ in range(k):
        state = step(state)
    leaves = ref_leaves(state)
    pwl, pecfg = praft.workload(port_cfg(CFG)), port_ecfg(ECFG)
    pstate = state_io.from_numpy_leaves(leaves, pwl, pecfg, device="cpu")
    assert_leaves_equal(leaves, state_io.to_numpy_leaves(pstate), "round trip")
    assert_leaves_equal(
        ref_leaves(step(state)),
        state_io.to_numpy_leaves(pcore.step_batch(pwl, pecfg, pstate, device="cpu")),
        f"step after {k}",
    )


def test_state_io_refuses_a_mismatched_state():
    pwl, pecfg = praft.workload(port_cfg(CFG)), port_ecfg(ECFG)
    leaves = state_io.to_numpy_leaves(pcore.init_sweep(pwl, pecfg, [1, 2], device="cpu"))
    with pytest.raises(ValueError):
        state_io.from_numpy_leaves(leaves[:-1], pwl, pecfg, device="cpu")
    bad = list(leaves)
    bad[2] = bad[2].astype(np.int32)  # now_ns must be int64
    with pytest.raises(ValueError):
        state_io.from_numpy_leaves(bad, pwl, pecfg, device="cpu")
