"""Port parity: the S3 model (``madsim_tpu_torch.models.s3``) against
``madsim_tpu.models.s3`` on JAX's CPU backend — every leaf of the batched
state after a few step counts and at the end (the default config, the
ack-before-durable bug, and a gray-failure campaign on the server), the
``sweep_summary`` dicts (``limit=``, a chunk-merged total over a ragged
tail, and the per-lane ``ops_done`` fold's int64 dtype), ``run_traced``
of a violating seed, the ``FaultEnvelope``/``params=`` path, and the
engine sizing."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from madsim_tpu.engine import core as rcore
from madsim_tpu.engine import faults as rfaults
from madsim_tpu.models import s3 as rs3
from madsim_tpu_torch.engine import core as pcore
from madsim_tpu_torch.engine import faults as pfaults
from madsim_tpu_torch.engine import state_io, tree
from madsim_tpu_torch.models import _common as pcommon
from madsim_tpu_torch.models import s3 as ps3

from _torch_parity import assert_leaves_equal, port_ecfg, port_spec, ref_leaves

SEEDS = np.arange(48, dtype=np.int64)
HORIZON = 1_500_000_000

CONFIGS = {
    "default": {},
    "ack_before_durable": dict(chip_smoke.S3_BUG),
    # server pauses, a slow disk and clock skew, client partitions and
    # bursts, in bug mode (the flush chain runs)
    "gray_server": {
        "faults": rfaults.FaultSpec(
            crashes=2, crash_window_ns=1_200_000_000, crash_group=(0, 1),
            pauses=1, pause_window_ns=1_000_000_000, pause_group=(0, 1),
            fsync_stalls=1, fsync_window_ns=800_000_000, fsync_group=(0, 1),
            skews=1, skew_window_ns=800_000_000, skew_group=(0, 2),
            partitions=1, part_window_ns=800_000_000, spikes=1, losses=1,
        ),
        "bug_ack_before_durable": True,
    },
}


def port_cfg(cfg):
    """The port's S3Config with the reference config's fields."""
    d = cfg._asdict()
    d["faults"] = port_spec(d["faults"])
    return ps3.S3Config(**d)


def _configs(name):
    rcfg = rs3.S3Config(**CONFIGS[name])
    ecfg = rs3.engine_config(rcfg, time_limit_ns=HORIZON)
    return rcfg, ecfg, port_cfg(rcfg), port_ecfg(ecfg)


@functools.lru_cache(maxsize=None)
def _swept(name):
    rcfg, ecfg, pcfg, pecfg = _configs(name)
    ref = rcore.run_sweep(rs3.workload(rcfg), ecfg, jnp.asarray(SEEDS))
    port = pcore.run_sweep(ps3.workload(pcfg), pecfg, SEEDS, device="cpu")
    return name, ref, port


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def swept(request):
    return _swept(request.param)


def test_every_leaf_equal(swept):
    name, ref, port = swept
    assert_leaves_equal(ref_leaves(ref), state_io.to_numpy_leaves(port), name)
    assert bool(port.done.all())


def test_every_leaf_equal_after_a_few_steps():
    """``step_batch`` by ``step_batch``: every leaf after 17 and 40 events."""
    rcfg, ecfg, pcfg, pecfg = _configs("ack_before_durable")
    rwl, pwl = rs3.workload(rcfg), ps3.workload(pcfg)
    rstep = jax.jit(rcore.step_batch, static_argnums=(0, 1))
    ref = rcore.init_sweep(rwl, ecfg, jnp.asarray(SEEDS[:32]))
    port = pcore.init_sweep(pwl, pecfg, SEEDS[:32], device="cpu")
    for steps in range(1, 41):
        ref = rstep(rwl, ecfg, ref)
        port = pcore.step_batch(pwl, pecfg, port, device="cpu")
        if steps in (17, 40):
            assert_leaves_equal(ref_leaves(ref), state_io.to_numpy_leaves(port),
                                f"{steps} steps")
    assert int(port.ctr.max()) == 40 and not bool(port.done.all())


def test_summary_equal(swept):
    name, ref, port = swept
    summary = ps3.sweep_summary(port)
    assert summary == rs3.sweep_summary(ref)
    assert summary["events_total"] > 0 and summary["puts"] > 0 and summary["gets"] > 0
    assert summary["completes"] > 0 and summary["ops_done"] > 0
    if name == "default":
        assert summary["violations"] == 0
    else:
        assert summary["violations"] > 0


def test_ops_done_lane_fold_is_int64():
    """The reference's ``jnp.sum(ops_done, axis=-1)`` has no ``dtype=``,
    so under x64 the per-lane fold is int64; the port's is too."""
    _name, ref, port = _swept("default")
    want = jnp.sum(ref.wstate.ops_done, axis=-1)
    got = port.wstate.ops_done.sum(dim=-1)
    assert str(want.dtype) == "int64" and got.dtype == torch.int64
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("limit", [1, 29, 48])
def test_summary_limit_equal(swept, limit):
    _name, ref, port = swept
    assert ps3.sweep_summary(port, limit=limit) == rs3.sweep_summary(ref, limit=limit)


def test_chunked_sweep_with_ragged_tail_equal():
    """32-seed chunks over 48 seeds (the last one ragged): the merged
    per-chunk summaries equal the reference's whole-sweep summary."""
    name, ref, _port = _swept("ack_before_durable")
    _rcfg, _ecfg, pcfg, pecfg = _configs(name)
    chunked = pcore.run_sweep_chunked(ps3.workload(pcfg), pecfg, SEEDS, chunk_size=32,
                                      device="cpu")
    totals = {}
    for lo in range(0, 48, 32):
        pcommon.merge_summaries(totals, ps3.sweep_summary(tree.map(lambda a: a[lo:lo + 32],
                                                                   chunked)))
    assert totals == rs3.sweep_summary(ref)


def test_run_traced_equal_on_a_violating_seed():
    """The ack-before-durable seed ``chip_smoke.py`` replays on the card
    (the model has no probe, so the trace has none)."""
    rcfg = rs3.S3Config(**chip_smoke.S3_BUG)
    ecfg = rs3.engine_config(rcfg, max_steps=450)
    seed = chip_smoke.S3_REPLAY_SEED
    rfinal, rtrace = rcore.run_traced(rs3.workload(rcfg), ecfg, seed)
    pfinal, ptrace = pcore.run_traced(ps3.workload(port_cfg(rcfg)), port_ecfg(ecfg), seed,
                                      device="cpu")
    keys = ("time_ns", "kind", "pay", "fired")
    assert sorted(ptrace) == sorted(rtrace) == sorted(keys)
    assert_leaves_equal(
        [np.asarray(rtrace[k]) for k in keys], [ptrace[k].numpy() for k in keys], "trace"
    )
    assert_leaves_equal(ref_leaves(rfinal), state_io.to_numpy_leaves(pfinal), "final")
    assert bool(pfinal.wstate.violation) and bool(pfinal.done)


def test_fault_envelope_params_path_equal():
    """Two candidates in one envelope, lanes of each through
    ``grid_params``: every leaf and the summary."""
    base = rfaults.FaultSpec(crashes=1, crash_window_ns=1_000_000_000, crash_group=(0, 1))
    cands = (base, base._replace(crashes=2, fsync_stalls=1, fsync_window_ns=800_000_000,
                                 fsync_group=(0, 1)))
    renv = rfaults.campaign_envelope(*cands)
    rcfg = rs3.S3Config(faults=renv, bug_ack_before_durable=True)
    ecfg = rs3.engine_config(rcfg, time_limit_ns=HORIZON)
    pcfg = port_cfg(rcfg)
    lanes = 16
    seeds = np.tile(np.arange(lanes, dtype=np.int64), 2)
    rparams = rfaults.grid_params(
        [rfaults.spec_to_params(c, renv, rcfg.num_nodes) for c in cands], lanes)
    pparams = pfaults.grid_params(
        [pfaults.spec_to_params(port_spec(c), pcfg.faults, pcfg.num_nodes) for c in cands],
        lanes)
    ref = rcore.run_sweep(rs3.workload(rcfg), ecfg, jnp.asarray(seeds), params=rparams)
    port = pcore.run_sweep(ps3.workload(pcfg), port_ecfg(ecfg), seeds, device="cpu",
                           params=pparams)
    assert_leaves_equal(ref_leaves(ref), state_io.to_numpy_leaves(port), "envelope")
    assert ps3.sweep_summary(port) == rs3.sweep_summary(ref)


@pytest.mark.parametrize("fields", [{}, {"num_clients": 5, "num_keys": 6}])
def test_engine_sizing_equal(fields):
    rcfg = rs3.S3Config(**fields)
    ecfg = rs3.engine_config(rcfg)
    pecfg = ps3.engine_config(port_cfg(rcfg))
    assert pecfg == port_ecfg(ecfg)
    got = pcore.state_bytes_per_seed(ps3.workload(port_cfg(rcfg)), pecfg)
    assert got == rcore.state_bytes_per_seed(rs3.workload(rcfg), ecfg)
    if not fields:
        assert (pecfg.queue_capacity, pecfg.time_limit_ns) == (48, 5_000_000_000)
    assert ps3.workload() is ps3.workload(ps3.S3Config())
