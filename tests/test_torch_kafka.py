"""Port parity: the kafka model (``madsim_tpu_torch.models.kafka``) against
``madsim_tpu.models.kafka`` on JAX's CPU backend — every leaf of the
batched state after a few step counts and at the end (the default
config, the ack-on-append bug with history recording, and a
gray-failure campaign on the broker), the ``sweep_summary`` dicts (``limit=`` and a
chunk-merged total over a ragged tail), ``run_traced`` of a violating
seed, the ``FaultEnvelope``/``params=`` path, and the engine sizing."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from madsim_tpu.engine import core as rcore
from madsim_tpu.engine import faults as rfaults
from madsim_tpu.models import kafka as rkafka
from madsim_tpu_torch.engine import core as pcore
from madsim_tpu_torch.engine import faults as pfaults
from madsim_tpu_torch.engine import state_io, tree
from madsim_tpu_torch.models import _common as pcommon
from madsim_tpu_torch.models import kafka as pkafka
from madsim_tpu_torch.oracle import specs as pspecs

from _torch_parity import assert_leaves_equal, port_ecfg, port_spec, ref_leaves

SEEDS = np.arange(48, dtype=np.int64)
HORIZON = 1_000_000_000

CONFIGS = {
    "default": {},
    "ack_on_append": dict(chip_smoke.KAFKA_BUG, hist_slots=48),
    # pauses, a slow disk and clock skew on the broker, a partition and
    # bursts: every FaultEdges transition and the stalled/skewed timers
    "gray_broker": {
        "faults": rfaults.FaultSpec(
            crashes=2, crash_window_ns=800_000_000, crash_group=(0, 1),
            pauses=1, pause_window_ns=800_000_000, pause_group=(0, 1),
            fsync_stalls=1, fsync_window_ns=600_000_000, fsync_group=(0, 1),
            skews=1, skew_window_ns=600_000_000, skew_group=(0, 3),
            partitions=1, part_window_ns=600_000_000, spikes=1, losses=1,
        ),
        "bug_ack_on_append": True,
    },
}


def port_cfg(cfg):
    """The port's KafkaConfig with the reference config's fields."""
    d = cfg._asdict()
    d["faults"] = port_spec(d["faults"])
    return pkafka.KafkaConfig(**d)


def _configs(name, **engine):
    rcfg = rkafka.KafkaConfig(**CONFIGS[name])
    ecfg = rkafka.engine_config(rcfg, time_limit_ns=HORIZON, **engine)
    return rcfg, ecfg, port_cfg(rcfg), port_ecfg(ecfg)


def _both(name, seeds=SEEDS, **engine):
    rcfg, ecfg, pcfg, pecfg = _configs(name, **engine)
    ref = rcore.run_sweep(rkafka.workload(rcfg), ecfg, jnp.asarray(seeds))
    port = pcore.run_sweep(pkafka.workload(pcfg), pecfg, seeds, device="cpu")
    return ref, port


@functools.lru_cache(maxsize=None)
def _swept(name):
    return (name,) + _both(name)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def swept(request):
    return _swept(request.param)


def test_every_leaf_equal(swept):
    name, ref, port = swept
    assert_leaves_equal(ref_leaves(ref), state_io.to_numpy_leaves(port), name)
    assert bool(port.done.all())


def test_every_leaf_equal_after_a_few_steps():
    """``step_batch`` by ``step_batch``: every leaf after 17 and 40 events."""
    rcfg, ecfg, pcfg, pecfg = _configs("ack_on_append")
    rwl, pwl = rkafka.workload(rcfg), pkafka.workload(pcfg)
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
    summary = pkafka.sweep_summary(port)
    assert summary == rkafka.sweep_summary(ref)
    assert summary["events_total"] > 0 and summary["appended"] > 0
    assert summary["fetched"] > 0 and summary["crashes"] > 0
    if name in ("ack_on_append", "gray_broker"):
        assert summary["violations"] > 0 and summary["ack_loss_seeds"] > 0
    if name == "default":
        assert summary["violations"] == 0


@pytest.mark.parametrize("limit", [1, 29, 48])
def test_summary_limit_equal(swept, limit):
    _name, ref, port = swept
    assert pkafka.sweep_summary(port, limit=limit) == rkafka.sweep_summary(ref, limit=limit)


def test_chunked_sweep_with_ragged_tail_equal():
    """32-seed chunks over 48 seeds (the last one ragged): the merged
    per-chunk summaries equal the reference's whole-sweep summary."""
    name, ref, _port = _swept("ack_on_append")
    _rcfg, _ecfg, pcfg, pecfg = _configs(name)
    chunked = pcore.run_sweep_chunked(pkafka.workload(pcfg), pecfg, SEEDS, chunk_size=32,
                                      device="cpu")
    totals = {}
    for lo in range(0, 48, 32):
        pcommon.merge_summaries(totals, pkafka.sweep_summary(tree.map(lambda a: a[lo:lo + 32],
                                                                      chunked)))
    assert totals == rkafka.sweep_summary(ref)


def test_run_traced_equal_on_a_violating_seed():
    """The ack-on-append seed ``chip_smoke.py`` replays on the card."""
    rcfg = rkafka.KafkaConfig(**chip_smoke.KAFKA_BUG)
    ecfg = rkafka.engine_config(rcfg, time_limit_ns=chip_smoke.KAFKA_HORIZON_NS,
                                max_steps=500)
    seed = chip_smoke.KAFKA_REPLAY_SEED
    rfinal, rtrace = rcore.run_traced(rkafka.workload(rcfg), ecfg, seed)
    pfinal, ptrace = pcore.run_traced(pkafka.workload(port_cfg(rcfg)), port_ecfg(ecfg), seed,
                                      device="cpu")
    keys = ("time_ns", "kind", "pay", "fired", "probe")
    assert sorted(ptrace) == sorted(rtrace) == sorted(keys)
    assert_leaves_equal(
        [np.asarray(rtrace[k]) for k in keys], [ptrace[k].numpy() for k in keys], "trace"
    )
    assert_leaves_equal(ref_leaves(rfinal), state_io.to_numpy_leaves(pfinal), "final")
    assert bool(pfinal.wstate.violation) and int(ptrace["probe"][-1]) & pkafka.V_ACK_LOSS


def test_fault_envelope_params_path_equal():
    """Two candidates in one envelope, lanes of each through
    ``grid_params``: every leaf and the summary."""
    base = rfaults.FaultSpec(crashes=1, crash_window_ns=800_000_000, crash_group=(0, 1))
    cands = (base, base._replace(crashes=2, pauses=1, pause_window_ns=800_000_000))
    renv = rfaults.campaign_envelope(*cands)
    rcfg = rkafka.KafkaConfig(faults=renv, bug_ack_on_append=True)
    ecfg = rkafka.engine_config(rcfg, time_limit_ns=HORIZON)
    pcfg = port_cfg(rcfg)
    lanes = 16
    seeds = np.tile(np.arange(lanes, dtype=np.int64), 2)
    rparams = rfaults.grid_params(
        [rfaults.spec_to_params(c, renv, rcfg.num_nodes) for c in cands], lanes)
    pparams = pfaults.grid_params(
        [pfaults.spec_to_params(port_spec(c), pcfg.faults, pcfg.num_nodes) for c in cands],
        lanes)
    ref = rcore.run_sweep(rkafka.workload(rcfg), ecfg, jnp.asarray(seeds), params=rparams)
    port = pcore.run_sweep(pkafka.workload(pcfg), port_ecfg(ecfg), seeds, device="cpu",
                           params=pparams)
    assert_leaves_equal(ref_leaves(ref), state_io.to_numpy_leaves(port), "envelope")
    assert pkafka.sweep_summary(port) == rkafka.sweep_summary(ref)
    assert int(port.wstate.crash_count[lanes:].sum()) > int(port.wstate.crash_count[:lanes].sum())


def test_history_rows_recorded(swept):
    """The record hook wrote produce and fetch rows, invokes and oks."""
    name, _ref, port = swept
    if not CONFIGS[name].get("hist_slots"):
        assert port.hist_rec.shape[1] == 0
        return
    n = port.hist_len
    assert int(n.min()) > 0
    codes = set(port.hist_rec[:, :, 1][
        np.arange(port.hist_rec.shape[1])[None, :] < n.numpy()[:, None]].tolist())
    assert codes == {6, 7, 8, 9}  # produce/fetch x invoke/ok


@pytest.mark.parametrize("fields", [{}, {"hist_slots": 512}, {"num_producers": 3,
                                                             "partitions": 3}])
def test_engine_sizing_equal(fields):
    rcfg = rkafka.KafkaConfig(**fields)
    ecfg = rkafka.engine_config(rcfg, time_limit_ns=2_000_000_000)
    pecfg = pkafka.engine_config(port_cfg(rcfg), time_limit_ns=2_000_000_000)
    assert pecfg == port_ecfg(ecfg)
    got = pcore.state_bytes_per_seed(pkafka.workload(port_cfg(rcfg)), pecfg)
    assert got == rcore.state_bytes_per_seed(rkafka.workload(rcfg), ecfg)
    if not fields:
        assert pecfg.queue_capacity == 48


def test_history_spec_and_workload():
    assert isinstance(pkafka.history_spec(), pspecs.LogSpec)
    assert pkafka.history_spec().name == rkafka.history_spec().name == "log"
    assert pkafka.workload() is pkafka.workload(pkafka.KafkaConfig())
    assert pkafka.workload().record is None
    assert pkafka.workload(pkafka.KafkaConfig(hist_slots=8)).record is not None
