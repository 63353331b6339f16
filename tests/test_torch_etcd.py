"""Port parity: the etcd model (``madsim_tpu_torch.models.etcd``) against
``madsim_tpu.models.etcd`` on JAX's CPU backend — every leaf of the final
batched state for the default config, each bug flag, history recording
and a fault campaign with crashes and partitions; the ``sweep_summary``
dicts (``limit=`` too); ``run_traced``; and the engine sizing."""

import jax.numpy as jnp
import numpy as np
import pytest

from madsim_tpu.engine import core as rcore
from madsim_tpu.engine import faults as rfaults
from madsim_tpu.models import etcd as retcd
from madsim_tpu_torch.engine import core as pcore
from madsim_tpu_torch.engine import state_io
from madsim_tpu_torch.models import etcd as petcd
from madsim_tpu_torch.oracle import specs as pspecs

from _torch_parity import assert_leaves_equal, port_ecfg, port_spec, ref_leaves

SEEDS = np.arange(24, dtype=np.int64)
HORIZON = 2_000_000_000

CONFIGS = {
    "default": {},
    "skip_expiry": {"bug_skip_expiry": True},
    "rev_regress": {"bug_rev_regress": True},
    "stale_read": {"bug_stale_read": True, "hist_slots": 48},
    "history": {"hist_slots": 32},
    "crash_partition_faults": {
        "faults": rfaults.FaultSpec(
            crashes=2, crash_window_ns=800_000_000, restart_lo_ns=50_000_000,
            restart_hi_ns=200_000_000, partitions=1, part_window_ns=800_000_000,
            part_lo_ns=100_000_000, part_hi_ns=300_000_000,
        ),
        "hist_slots": 32,
    },
}


def port_cfg(cfg):
    """The port's EtcdConfig with the reference config's fields."""
    d = cfg._asdict()
    d["faults"] = port_spec(d["faults"])
    return petcd.EtcdConfig(**d)


def _configs(name):
    rcfg = retcd.EtcdConfig(**CONFIGS[name])
    ecfg = retcd.engine_config(rcfg, time_limit_ns=HORIZON)
    return rcfg, ecfg, port_cfg(rcfg), port_ecfg(ecfg)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def swept(request):
    rcfg, ecfg, pcfg, pecfg = _configs(request.param)
    ref = rcore.run_sweep(retcd.workload(rcfg), ecfg, jnp.asarray(SEEDS))
    port = pcore.run_sweep(petcd.workload(pcfg), pecfg, SEEDS, device="cpu")
    return request.param, ref, port


def test_every_leaf_equal(swept):
    name, ref, port = swept
    assert_leaves_equal(ref_leaves(ref), state_io.to_numpy_leaves(port), name)
    assert bool(port.done.all())


def test_summary_equal(swept):
    name, ref, port = swept
    summary = petcd.sweep_summary(port)
    assert summary == retcd.sweep_summary(ref)
    assert summary["events_total"] > 0 and summary["puts"] > 0
    # the bug flags change what runs: expiry is a no-op, or steps the
    # revision back (the online checkers need longer sweeps to fire)
    if name == "skip_expiry":
        assert summary["expiries"] == summary["keys_expired"] == 0
    if name == "default":
        assert summary["expiries"] > 0 and summary["keys_expired"] > 0
    if name == "crash_partition_faults":
        assert summary["partitions"] > 0


@pytest.mark.parametrize("limit", [1, 13, 24])
def test_summary_limit_equal(swept, limit):
    _name, ref, port = swept
    assert petcd.sweep_summary(port, limit=limit) == retcd.sweep_summary(ref, limit=limit)


@pytest.mark.parametrize("name,seed", [("stale_read", 5), ("rev_regress", 2**32 + 7)])
def test_run_traced_equal(name, seed):
    rcfg, ecfg, pcfg, pecfg = _configs(name)
    ecfg = ecfg._replace(max_steps=300)
    rfinal, rtrace = rcore.run_traced(retcd.workload(rcfg), ecfg, seed)
    pfinal, ptrace = pcore.run_traced(petcd.workload(pcfg), port_ecfg(ecfg), seed, device="cpu")
    keys = ("time_ns", "kind", "pay", "fired", "probe")
    assert sorted(ptrace) == sorted(rtrace) == sorted(keys)
    assert_leaves_equal(
        [np.asarray(rtrace[k]) for k in keys], [ptrace[k].numpy() for k in keys], "trace"
    )
    assert_leaves_equal(ref_leaves(rfinal), state_io.to_numpy_leaves(pfinal), "final")
    assert int(ptrace["fired"].sum()) > 50


@pytest.mark.parametrize("fields", [{}, {"hist_slots": 256}, {"num_clients": 3, "num_keys": 9}])
def test_engine_sizing_equal(fields):
    """Queue capacity and loop-carry bytes per seed: the bench config
    (``hist_slots=256``, 2 s horizon) is queue 48 and 9,755 B per seed."""
    rcfg = retcd.EtcdConfig(**fields)
    ecfg = retcd.engine_config(rcfg, time_limit_ns=2_000_000_000)
    pecfg = petcd.engine_config(port_cfg(rcfg), time_limit_ns=2_000_000_000)
    assert pecfg == port_ecfg(ecfg)
    got = pcore.state_bytes_per_seed(petcd.workload(port_cfg(rcfg)), pecfg)
    assert got == rcore.state_bytes_per_seed(retcd.workload(rcfg), ecfg)
    if fields == {"hist_slots": 256}:
        assert (pecfg.queue_capacity, got) == (48, 9_755)
    assert petcd.cover_bits(port_cfg(rcfg)) == retcd.cover_bits(rcfg)


def test_history_spec_is_the_kv_register():
    assert isinstance(petcd.history_spec(), pspecs.KVSpec)
    assert petcd.history_spec().name == retcd.history_spec().name == "kv"


def test_workload_is_memoized_and_records_only_with_slots():
    assert petcd.workload() is petcd.workload(petcd.EtcdConfig())
    assert petcd.workload().record is None
    assert petcd.workload(petcd.EtcdConfig(hist_slots=8)).record is not None
    with pytest.raises(ValueError, match="lease key"):
        pcore.init_sweep(
            petcd.workload(petcd.EtcdConfig(num_clients=3, num_keys=2)),
            petcd.engine_config(), [0], device="cpu",
        )
