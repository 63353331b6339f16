"""Port parity: the checked sweep end to end
(``madsim_tpu_torch.oracle.screen.checked_sweep``, ``device="cpu"``)
against ``madsim_tpu.oracle.screen.checked_sweep`` — the report dicts as
JSON bytes, for etcd clean and with the stale-read bug over 100 seeds in
chunks of 32 (a ragged tail), across ``workers``, ``screen`` and
``device_decode``; raft histories under ``ElectionSpec``; the routes not
ported yet refuse; and ``violating_seeds``."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from madsim_tpu.engine import core as rcore
from madsim_tpu.models import etcd as retcd
from madsim_tpu.models import raft as rraft
from madsim_tpu.oracle import check as rcheck
from madsim_tpu.oracle import screen as rscreen
from madsim_tpu_torch.engine import core as pcore
from madsim_tpu_torch.models import etcd as petcd
from madsim_tpu_torch.models import raft as praft
from madsim_tpu_torch.oracle import check as pcheck
from madsim_tpu_torch.oracle import screen as pscreen
from madsim_tpu_torch.oracle import specs as pspecs

from _torch_parity import port_cfg as port_raft_cfg
from _torch_parity import port_ecfg

SEEDS = np.arange(100, dtype=np.int64)
CHUNK = 32


def _bytes(report):
    return json.dumps(report, sort_keys=True)


def _etcd(stale):
    rcfg = retcd.EtcdConfig(hist_slots=48, bug_stale_read=stale)
    ecfg = retcd.engine_config(rcfg, time_limit_ns=1_000_000_000)
    return rcfg, ecfg, petcd.EtcdConfig(**rcfg._asdict()), port_ecfg(ecfg)


@pytest.fixture(scope="module", params=[False, True], ids=["clean", "stale"])
def etcd_case(request):
    """The reference's reports, screened and unscreened."""
    rcfg, ecfg, pcfg, pecfg = _etcd(request.param)
    ref = {
        screen: rscreen.checked_sweep(
            retcd.workload(rcfg), ecfg, SEEDS, retcd.history_spec(), retcd.sweep_summary,
            chunk_size=CHUNK, screen=screen,
        )
        for screen in (True, False)
    }
    return request.param, pcfg, pecfg, ref


VARIANTS = [
    {"workers": 0, "screen": True, "device_decode": False},
    {"workers": 2, "screen": True, "device_decode": True},
    {"workers": 0, "screen": False, "device_decode": True},
    {"workers": 2, "screen": False, "device_decode": False},
]


@pytest.mark.parametrize("kw", VARIANTS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_checked_sweep_report_bytes_equal(etcd_case, kw):
    stale, pcfg, pecfg, ref = etcd_case
    got = pscreen.checked_sweep(
        petcd.workload(pcfg), pecfg, SEEDS, petcd.history_spec(), petcd.sweep_summary,
        chunk_size=CHUNK, device="cpu", **kw,
    )
    assert _bytes(got) == _bytes(ref[kw["screen"]])
    assert got["seeds"] == len(SEEDS) and got["hist_screened"] == len(SEEDS)
    if stale:
        assert got["hist_violations"] > 0 and got["violations"] == 0
        assert len(got["hist_violating_seeds"]) == 32
    else:
        assert got["hist_violations"] == 0


def test_raft_histories_under_the_election_spec():
    rcfg = rraft.RaftConfig(num_nodes=3, crashes=2, hist_slots=8)
    ecfg = rraft.engine_config(rcfg, time_limit_ns=1_500_000_000)
    seeds = np.arange(40, dtype=np.int64)
    ref = rscreen.checked_sweep(
        rraft.workload(rcfg), ecfg, seeds, rraft.history_spec(), rraft.sweep_summary,
        chunk_size=16,
    )
    got = pscreen.checked_sweep(
        praft.workload(port_raft_cfg(rcfg)), port_ecfg(ecfg), seeds, praft.history_spec(),
        praft.sweep_summary, chunk_size=16, device="cpu",
    )
    assert isinstance(praft.history_spec(), pspecs.ElectionSpec)
    assert _bytes(got) == _bytes(ref)
    assert got["hist_screened"] == 40


def test_violating_seeds_equal():
    rcfg, ecfg, pcfg, pecfg = _etcd(True)
    seeds = np.arange(24, dtype=np.int64)
    rfinal = rcore.run_sweep(retcd.workload(rcfg), ecfg, jnp.asarray(seeds))
    pfinal = pcore.run_sweep(petcd.workload(pcfg), pecfg, seeds, device="cpu")
    want = rcheck.violating_seeds(rfinal, retcd.history_spec(), screen=True)
    for screen in (True, False, "auto"):
        stats = {}
        got = pcheck.violating_seeds(pfinal, petcd.history_spec(), screen=screen, stats=stats)
        assert got.dtype == np.int64 and got.tolist() == want.tolist()
        assert stats["budget_exceeded"] == 0
    assert len(want) > 0


def test_routes_not_ported_yet_refuse():
    _rcfg, _ecfg, pcfg, pecfg = _etcd(False)
    args = (petcd.workload(pcfg), pecfg, SEEDS[:4], petcd.history_spec(), petcd.sweep_summary)
    # the mesh route is ported: on a one-rank mesh chunk_per_device is the
    # chunk, and the report is the unsharded one (tests/test_torch_mesh_checked.py
    # runs more ranks); without a mesh chunk_per_device is ignored, as in
    # the reference
    from madsim_tpu_torch.parallel import seed_mesh

    plain = pscreen.checked_sweep(*args, chunk_size=2, device="cpu")
    assert pscreen.checked_sweep(*args, mesh=seed_mesh(device="cpu"), chunk_per_device=2) == plain
    assert pscreen.checked_sweep(*args, chunk_size=2, chunk_per_device=3, device="cpu") == plain
    # the stream driver is ported; it keeps its own snapshots
    with pytest.raises(ValueError, match="own snapshots"):
        pscreen.checked_sweep(*args, driver="stream", ckpt_dir="unused", device="cpu")
    with pytest.raises(ValueError, match="unknown driver"):
        pscreen.checked_sweep(*args, driver="bogus", device="cpu")
    with pytest.raises(ValueError, match="no device screen"):
        pscreen.checked_sweep(*args[:3], pspecs.S3Spec(), args[4], device="cpu")


class Recorder:
    """A duck-typed telemetry handle that keeps what it is told."""

    tracer = None

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name in ("count", "event", "observe", "gauge", "event_mix"):
            return lambda *a, **kw: self.calls.append(name)
        raise AttributeError(name)


def test_telemetry_records_out_of_band(etcd_case):
    stale, pcfg, pecfg, ref = etcd_case
    telemetry = Recorder()
    got = pscreen.checked_sweep(
        petcd.workload(pcfg), pecfg, SEEDS, petcd.history_spec(), petcd.sweep_summary,
        chunk_size=CHUNK, device="cpu", telemetry=telemetry,
    )
    assert _bytes(got) == _bytes(ref[True])
    for name in ("count", "event", "observe", "gauge", "event_mix"):
        assert name in telemetry.calls
