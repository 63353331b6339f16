"""Port parity: the MadRaft sweep end to end on the tiny flagship.

``madsim_tpu_torch`` (``device="cpu"``, the plain torch path) against
``madsim_tpu`` on JAX's CPU backend: every leaf of the final batched
state, the ``sweep_summary`` dicts, the chunked sweep with a ragged tail
merged by ``merge_summaries``, and the opt-in history/event-mix planes —
exact equality of value, dtype and shape."""

import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__
from madsim_tpu.engine import core as rcore
from madsim_tpu.models import _common as rcommon
from madsim_tpu.models import raft as rraft
from madsim_tpu_torch.engine import core as pcore
from madsim_tpu_torch.engine import state_io, tree
from madsim_tpu_torch.models import _common as pcommon
from madsim_tpu_torch.models import raft as praft

from _torch_parity import assert_leaves_equal, port_cfg, port_ecfg, ref_leaves

SEEDS = np.arange(64, dtype=np.int64)


@pytest.fixture(scope="module")
def tiny():
    """The tiny flagship (3 nodes, 1.5 s, queue 48) run by both packages."""
    _wl, cfg, ecfg = __graft_entry__._flagship(tiny=True)
    ref = rcore.run_sweep(rraft.workload(cfg), ecfg, jnp.asarray(SEEDS))
    pcfg, pecfg = port_cfg(cfg), port_ecfg(ecfg)
    port = pcore.run_sweep(praft.workload(pcfg), pecfg, SEEDS, device="cpu")
    return cfg, ecfg, pcfg, pecfg, ref, port


def test_tiny_flagship_every_leaf_equal(tiny):
    *_, ref, port = tiny
    assert_leaves_equal(ref_leaves(ref), state_io.to_numpy_leaves(port), "final")
    assert bool(port.done.all())


def test_tiny_flagship_summary_equal(tiny):
    *_, ref, port = tiny
    rsum, psum = rraft.sweep_summary(ref), praft.sweep_summary(port)
    assert psum == rsum
    assert psum["commits_total"] > 0 and psum["no_leader_seeds"] < 16


@pytest.mark.parametrize("limit", [1, 37, 64])
def test_summary_limit_equal(tiny, limit):
    *_, ref, port = tiny
    assert praft.sweep_summary(port, limit=limit) == rraft.sweep_summary(ref, limit=limit)


def test_chunked_sweep_with_ragged_tail_equal(tiny):
    """24-seed chunks over 64 seeds: the last chunk is padded to 24 and
    trimmed. The merged per-chunk summaries equal the whole sweep's, and
    the concatenated finals equal the reference lane for lane."""
    _cfg, _ecfg, pcfg, pecfg, ref, _port = tiny
    wl = praft.workload(pcfg)
    chunked = pcore.run_sweep_chunked(wl, pecfg, SEEDS, chunk_size=24, device="cpu")
    assert_leaves_equal(ref_leaves(ref), state_io.to_numpy_leaves(chunked), "chunked")
    totals = {}
    for lo in range(0, 64, 24):
        part = tree.map(lambda a: a[lo : lo + 24], chunked)
        pcommon.merge_summaries(totals, praft.sweep_summary(part))
    assert totals == rraft.sweep_summary(ref)


def test_merge_summaries_matches_reference():
    a = {"seeds": 3, "queue_high_water": 9, "coverage_map": [1, 4],
         "event_mix": [1, 2], "violating": [5], "events_total": 10}
    b = {"seeds": 2, "queue_high_water": 7, "coverage_map": [2, 4, 8],
         "event_mix": [3, 0, 1], "violating": [9], "events_total": 5}
    ref = rcommon.merge_summaries(rcommon.merge_summaries({}, a), b)
    port = pcommon.merge_summaries(pcommon.merge_summaries({}, a), b)
    assert port == ref
    assert pcommon.coverage_bit_count(port["coverage_map"]) == rcommon.coverage_bit_count(
        ref["coverage_map"])


def test_history_and_event_mix_planes_equal():
    """The opt-in planes: election-history rows and the event-kind
    histogram (hist_slots=4 is small enough to overflow)."""
    _wl, cfg, ecfg = __graft_entry__._flagship(tiny=True)
    cfg = cfg._replace(hist_slots=4, event_mix=True)
    ecfg = rraft.engine_config(cfg, queue_capacity=48, time_limit_ns=1_000_000_000,
                               max_steps=6_000)
    seeds = SEEDS[:32]
    ref = rcore.run_sweep(rraft.workload(cfg), ecfg, jnp.asarray(seeds))
    port = pcore.run_sweep(praft.workload(port_cfg(cfg)), port_ecfg(ecfg), seeds,
                           device="cpu")
    assert_leaves_equal(ref_leaves(ref), state_io.to_numpy_leaves(port), "planes")
    psum = praft.sweep_summary(port)
    assert psum == rraft.sweep_summary(ref)
    assert sum(psum["event_mix"]) == psum["events_total"]
    assert int(port.hist_len.sum()) > 0


def test_engine_config_and_state_bytes_match_reference():
    cfg = rraft.RaftConfig(num_nodes=5, crashes=1)
    ecfg = rraft.engine_config(cfg, queue_capacity=64)
    pcfg, pecfg = port_cfg(cfg), port_ecfg(ecfg)
    assert tuple(praft.engine_config(pcfg, queue_capacity=64)) == tuple(ecfg)
    assert tuple(praft.engine_config(pcfg)) == tuple(rraft.engine_config(cfg))
    assert pcore.state_bytes_per_seed(praft.workload(pcfg), pecfg) == (
        rcore.state_bytes_per_seed(rraft.workload(cfg), ecfg)
    )

