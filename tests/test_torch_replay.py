"""Port parity: the bit-exact single-seed replay ``run_traced`` — every
trace key (``probe`` included) and every leaf of the final state."""

import numpy as np
import pytest

import __graft_entry__
from madsim_tpu import replay
from madsim_tpu.engine import core as rcore
from madsim_tpu.models import raft as rraft
from madsim_tpu_torch.engine import core as pcore
from madsim_tpu_torch.engine import state_io
from madsim_tpu_torch.models import raft as praft

from _torch_parity import assert_leaves_equal, port_cfg, port_ecfg, ref_leaves

KEYS = ("time_ns", "kind", "pay", "fired", "probe")


def _both(cfg, ecfg, seed):
    rfinal, rtrace = rcore.run_traced(rraft.workload(cfg), ecfg, seed)
    pfinal, ptrace = pcore.run_traced(
        praft.workload(port_cfg(cfg)), port_ecfg(ecfg), seed, device="cpu"
    )
    assert sorted(ptrace) == sorted(rtrace) == sorted(KEYS)
    assert_leaves_equal(
        [np.asarray(rtrace[k]) for k in KEYS], [ptrace[k].numpy() for k in KEYS], "trace"
    )
    assert_leaves_equal(ref_leaves(rfinal), state_io.to_numpy_leaves(pfinal), "final")
    return ptrace


@pytest.mark.parametrize("seed", [3, 2**32 + 11])
def test_run_traced_equal_on_tiny_flagship(seed):
    _wl, cfg, ecfg = __graft_entry__._flagship(tiny=True)
    trace = _both(cfg, ecfg, seed)
    assert int(trace["fired"].sum()) > 50


def test_run_traced_equal_on_a_violating_amnesia_seed():
    """Seed 6 of the amnesia config (crashes wipe durable state) latches
    a double-vote violation; the probe column locates the same first
    violating event in both packages."""
    cfg, ecfg = replay.amnesia_raft_config()
    trace = _both(cfg, ecfg, 6)
    probe = trace["probe"].numpy()
    assert probe.any(), "seed 6 no longer violates — the test would be vacuous"
    first = int(np.argmax(probe != 0))
    assert bool(trace["fired"][first])
