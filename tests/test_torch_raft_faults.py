"""Port parity: the raft sweep under every fault family.

The full gray-failure campaign (partitions, latency and loss bursts,
pauses, one-way partitions, slow disks with raft's durability shadow,
power failures, clock skew) through ``madsim_tpu_torch`` on the CPU
against ``madsim_tpu`` on JAX's CPU backend, with and without the amnesia
wipe, and under a step budget that cuts every seed — exact equality of
every leaf and of the summary."""

import jax.numpy as jnp
import numpy as np
import pytest

from madsim_tpu.engine import core as rcore
from madsim_tpu.engine import faults as rfaults
from madsim_tpu.models import raft as rraft
from madsim_tpu_torch.engine import core as pcore
from madsim_tpu_torch.engine import state_io
from madsim_tpu_torch.models import raft as praft

from _torch_parity import assert_leaves_equal, port_cfg, port_ecfg, ref_leaves

SEEDS = np.arange(32, dtype=np.int64)


GRAY = dict(
    crashes=2, crash_window_ns=800_000_000, restart_lo_ns=50_000_000,
    restart_hi_ns=200_000_000, partitions=1, part_window_ns=800_000_000,
    part_lo_ns=100_000_000, part_hi_ns=300_000_000, spikes=1,
    spike_window_ns=800_000_000, losses=1, loss_window_ns=800_000_000,
    pauses=2, pause_window_ns=800_000_000, aparts=1, apart_window_ns=800_000_000,
    fsync_stalls=2, fsync_window_ns=800_000_000, power_fails=1,
    power_window_ns=800_000_000, skews=2, skew_window_ns=800_000_000,
)


@pytest.mark.parametrize(
    "volatile,max_steps",
    [(False, 6_000), (True, 6_000), (False, 100)],
    ids=["gray", "gray_amnesia", "budget_cut"],
)
def test_every_fault_family_through_the_raft_sweep(volatile, max_steps):
    """Every fault family at once — partitions, bursts, pauses with
    resumed leaders, one-way partitions, slow disks with the durability
    shadow and its crash rollback, power failures, clock skew — with and
    without the amnesia wipe; and a step budget (100) that cuts every
    seed, which ``drive`` must honour exactly although it reads the
    all-done flag only once per 64 steps."""
    cfg = rraft.RaftConfig(
        num_nodes=3, commands=4, cmd_window_ns=600_000_000, volatile_state=volatile,
        faults=rfaults.FaultSpec(**GRAY),
    )
    ecfg = rraft.engine_config(cfg, time_limit_ns=1_000_000_000, max_steps=max_steps)
    seeds = SEEDS
    ref = rcore.run_sweep(rraft.workload(cfg), ecfg, jnp.asarray(seeds))
    port = pcore.run_sweep(praft.workload(port_cfg(cfg)), port_ecfg(ecfg), seeds,
                           device="cpu")
    assert_leaves_equal(ref_leaves(ref), state_io.to_numpy_leaves(port), "gray")
    assert praft.sweep_summary(port) == rraft.sweep_summary(ref)
    assert port.wstate.dur_term.shape == (32, 3)  # the shadow planes are live
    if max_steps == 100:
        assert int(port.ctr.max()) == 100 and not bool(port.done.all())
