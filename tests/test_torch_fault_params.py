"""Port parity: spec-as-data fault campaigns, literal schedules, the
legacy queue layout and the chunking helpers.

``madsim_tpu_torch`` (``device="cpu"``) against ``madsim_tpu`` on JAX's
CPU backend, with the cases of ``tests/test_fault_params.py``: the
padded derivation's draws and schedules per family, ``FaultParams``
field by field, the refusals, and raft sweeps through ``tile_params`` and
``grid_params``, the envelope replay, the chunked sweep with params over
a ragged tail, ``legacy_queue=1``, ``lane_slice`` and ``pick_chunk_size``
— exact equality of value, dtype and shape."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from madsim_tpu.engine import core as rcore
from madsim_tpu.engine import faults as rfaults
from madsim_tpu.models import raft as rraft
from madsim_tpu.replay import amnesia_raft_config
from madsim_tpu_torch.engine import core as pcore
from madsim_tpu_torch.engine import faults as pfaults
from madsim_tpu_torch.engine import rng as prng
from madsim_tpu_torch.engine import state_io, tree
from madsim_tpu_torch.engine.queue import INVALID_TIME
from madsim_tpu_torch.models import raft as praft

from _torch_parity import (
    assert_leaves_equal, port_cfg, port_ecfg, port_spec, ref_leaves,
)

NODES = 5
FULL = dict(
    crashes=2, crash_window_ns=1_500_000_000, restart_lo_ns=100_000_000,
    restart_hi_ns=400_000_000, partitions=2, part_window_ns=1_500_000_000,
    part_lo_ns=200_000_000, part_hi_ns=600_000_000, spikes=1, losses=1,
    pauses=1, aparts=2, apart_window_ns=1_200_000_000, fsync_stalls=1,
    power_fails=1, skews=1,
)
FIXED_EVENTS = (
    (100_000, "crash", 1),
    (200_000, "restart", 1),
    (200_000, "fsync_stall", 2),  # a deliberate time tie
    (300_000, "skew_on", 0),
    (400_000, "part_in", 3),
)


def _assert_params_equal(rp, pp):
    assert_leaves_equal(
        [np.asarray(a) for a in jax.tree.leaves(rp)],
        [np.asarray(a) for a in tree.leaves(pp)],
        "FaultParams",
    )


def _padded_equals_reference(rspec, renv, seeds, num_nodes=NODES):
    """The port's padded schedule for a batch of seeds, row for row, and
    its enabled rows against the reference's dense derivation."""
    pspec, penv = port_spec(rspec), port_spec(renv)
    rparams = rfaults.spec_to_params(rspec, renv, num_nodes)
    pparams = pfaults.spec_to_params(pspec, penv, num_nodes)
    _assert_params_equal(rparams, pparams)
    keys = prng.seed_key(torch.tensor(seeds, dtype=torch.int64))
    got = pfaults.schedule_events_padded(
        penv, pfaults.tile_params(pparams, len(seeds)), num_nodes, keys
    )
    for i, seed in enumerate(seeds):
        key = jax.random.key(seed)
        want = rfaults.schedule_events_padded(renv, rparams, num_nodes, key)
        for r, p in zip(want, got):
            np.testing.assert_array_equal(np.asarray(r), p[i].numpy())
        en = got[3][i].numpy()
        dense = rfaults.schedule_events(rspec, num_nodes, key)
        assert int(en.sum()) == int(dense[0].shape[0])
        for r, p in zip(dense, got[:3]):
            np.testing.assert_array_equal(np.asarray(r), p[i].numpy()[en])


def test_bits_at_matches_jax_random_bits():
    seeds = [0, 7, 0xDEAD, 1 << 40]
    keys = prng.seed_key(torch.tensor(seeds, dtype=torch.int64))
    idx = torch.arange(257, dtype=torch.int64).expand(len(seeds), -1)
    got = pfaults.bits_at(keys, idx)
    for i, seed in enumerate(seeds):
        ref = np.asarray(jax.random.bits(jax.random.key(seed), (257,), dtype=jnp.uint32))
        np.testing.assert_array_equal(ref.astype(np.int64), got[i].numpy())


@pytest.mark.parametrize("family", rfaults.FAMILIES)
def test_schedule_equivalence_per_family(family):
    assert pfaults.FAMILIES == rfaults.FAMILIES
    spec = rfaults.FaultSpec(**{family: 2})
    env = rfaults.campaign_envelope(spec, mutation_cap=4)
    assert port_spec(env) == pfaults.campaign_envelope(port_spec(spec), mutation_cap=4)
    _padded_equals_reference(spec, env, [0, 3, 99])


def test_schedule_equivalence_full_spec():
    spec = rfaults.FaultSpec(**FULL)
    env = rfaults.campaign_envelope(spec, mutation_cap=6)
    _padded_equals_reference(spec, env, [0, 1, 42, 1 << 40])


def test_schedule_equivalence_fixed_faults():
    fx = rfaults.FixedFaults(events=FIXED_EVENTS)
    env = rfaults.FaultEnvelope(fixed=12)
    _padded_equals_reference(fx, env, [0, 5])
    # the literal schedule through the static path, and the whole emit
    # stream of the envelope path: enabled rows compacted to the front
    pfx, penv = port_spec(fx), port_spec(env)
    keys = prng.seed_key(torch.tensor([5, 6], dtype=torch.int64))
    params = pfaults.tile_params(pfaults.spec_to_params(pfx, penv, NODES), 2)
    pdense = pfaults.compile_device(pfx, NODES, keys, 7, 4)
    ppadded = pfaults.compile_device(penv, NODES, keys, 7, 4, params=params)
    rkey = jax.random.key(5)
    rdense = rfaults.compile_device(fx, NODES, rkey, 7, 4)
    rpadded = rfaults.compile_device(
        env, NODES, rkey, 7, 4, params=rfaults.spec_to_params(fx, env, NODES)
    )
    for r, p in zip(rdense, pdense):
        np.testing.assert_array_equal(np.asarray(r), p[0].numpy())
    for r, p in zip(rpadded, ppadded):
        np.testing.assert_array_equal(np.asarray(r), p[0].numpy())
        np.testing.assert_array_equal(p[0].numpy(), p[1].numpy())  # seedless
    k = len(FIXED_EVENTS)
    assert ppadded.enables[:, :k].all() and not ppadded.enables[:, k:].any()


def test_spec_to_params_field_by_field():
    for rspec, renv in (
        (rfaults.FaultSpec(**FULL), rfaults.campaign_envelope(rfaults.FaultSpec(**FULL))),
        (rfaults.FaultSpec(crashes=1, part_group=(1, -1)),
         rfaults.campaign_envelope(mutation_cap=3, fixed=4)),
        (rfaults.FixedFaults(events=FIXED_EVENTS), rfaults.FaultEnvelope(fixed=8)),
    ):
        _assert_params_equal(
            rfaults.spec_to_params(rspec, renv, NODES),
            pfaults.spec_to_params(port_spec(rspec), port_spec(renv), NODES),
        )
    grid_r = rfaults.grid_params(
        [rfaults.spec_to_params(rfaults.FaultSpec(crashes=c), rfaults.campaign_envelope(
            mutation_cap=2), NODES) for c in (1, 2)], 3)
    grid_p = pfaults.grid_params(
        [pfaults.spec_to_params(pfaults.FaultSpec(crashes=c), pfaults.campaign_envelope(
            mutation_cap=2), NODES) for c in (1, 2)], 3)
    _assert_params_equal(grid_r, grid_p)
    stack_r = rfaults.stack_params([grid_r, grid_r])
    stack_p = pfaults.stack_params([grid_p, grid_p])
    _assert_params_equal(stack_r, stack_p)


def test_envelope_rejects_oversized_spec():
    env = pfaults.campaign_envelope(pfaults.FaultSpec(crashes=1))
    with pytest.raises(ValueError, match="envelope caps"):
        pfaults.spec_to_params(pfaults.FaultSpec(crashes=2), env, NODES)
    with pytest.raises(ValueError, match="fixed capacity"):
        pfaults.spec_to_params(pfaults.FixedFaults(events=((1, "crash", 0),)), env, NODES)
    with pytest.raises(ValueError, match="unknown fault action"):
        pfaults.spec_to_params(
            pfaults.FixedFaults(events=((1, "melt", 0),)), pfaults.FaultEnvelope(fixed=1), NODES
        )
    with pytest.raises(ValueError, match="outside"):
        pfaults.spec_to_params(
            pfaults.FixedFaults(events=((1, "crash", 9),)), pfaults.FaultEnvelope(fixed=1), NODES
        )
    with pytest.raises(ValueError, match="FaultParams"):
        pfaults.make_rt(env, None)


def test_envelope_static_gating():
    for spec in (rfaults.FaultSpec(skews=1), rfaults.FaultSpec(fsync_stalls=1),
                 rfaults.FaultSpec()):
        env = rfaults.campaign_envelope(spec)
        penv = port_spec(env)
        assert pfaults.can_skew(penv) == rfaults.can_skew(env)
        assert pfaults.can_stall(penv) == rfaults.can_stall(env)
        assert pfaults.num_events(penv) == rfaults.num_events(env)
    fx = rfaults.FixedFaults(events=FIXED_EVENTS)
    assert pfaults.can_skew(port_spec(fx)) == rfaults.can_skew(fx)
    assert pfaults.can_stall(port_spec(fx)) == rfaults.can_stall(fx)
    assert pfaults.num_events(port_spec(fx)) == rfaults.num_events(fx)


# -- raft sweeps through the spec-as-data path -------------------------------

SWEEP_KW = dict(time_limit_ns=1_500_000_000, max_steps=15_000)
SWEEP_SPEC = rfaults.FaultSpec(**FULL)._replace(aparts=1, crashes=3)
SWEEP_ENV = rfaults.campaign_envelope(SWEEP_SPEC, mutation_cap=6)


def _envelope_sweep(candidates, lanes, params_of):
    """The reference's and the port's raft sweep of ``candidates`` on the
    amnesia config through ``SWEEP_ENV``; ``params_of(module, per-candidate
    params)`` lays the params out per lane."""
    base, _ = amnesia_raft_config()
    cfg = base._replace(faults=SWEEP_ENV)
    ecfg = rraft.engine_config(cfg, **SWEEP_KW)
    seeds = np.tile(np.arange(lanes, dtype=np.int64), len(candidates))
    rparams = params_of(rfaults, [rfaults.spec_to_params(c, SWEEP_ENV, base.num_nodes)
                                  for c in candidates])
    pparams = params_of(pfaults, [pfaults.spec_to_params(port_spec(c), port_spec(SWEEP_ENV),
                                                         base.num_nodes) for c in candidates])
    ref = rcore.run_sweep(rraft.workload(cfg), ecfg, seeds, params=rparams)
    pcfg, pecfg = port_cfg(cfg), port_ecfg(ecfg)
    port = pcore.run_sweep(praft.workload(pcfg), pecfg, seeds, device="cpu", params=pparams)
    return (cfg, ecfg, pcfg, pecfg, seeds, rparams, pparams), ref, port


@pytest.fixture(scope="module")
def tiled():
    return _envelope_sweep([SWEEP_SPEC], 24, lambda m, ps: m.tile_params(ps[0], 24))


def test_raft_sweep_tile_params_equal(tiled):
    _, ref, port = tiled
    assert_leaves_equal(ref_leaves(ref), state_io.to_numpy_leaves(port), "tile_params")
    assert praft.sweep_summary(port) == rraft.sweep_summary(ref)


def test_raft_sweep_grid_params_and_lane_slice_equal():
    cands = [SWEEP_SPEC, rfaults.FaultSpec(crashes=2, partitions=1)]
    (cfg, *_), ref, port = _envelope_sweep(cands, 12, lambda m, ps: m.grid_params(ps, 12))
    assert_leaves_equal(ref_leaves(ref), state_io.to_numpy_leaves(port), "grid_params")
    for k in range(len(cands)):
        rpart = rcore.lane_slice(ref, 12, k * 12)
        ppart = pcore.lane_slice(port, 12, k * 12)
        assert_leaves_equal(ref_leaves(rpart), state_io.to_numpy_leaves(ppart), "lane_slice")
        assert praft.sweep_summary(ppart) == rraft.sweep_summary(rpart)


def test_run_sweep_chunked_params_ragged_tail_equal(tiled):
    (_cfg, _ecfg, pcfg, pecfg, seeds, _rp, pparams), _ref, port = tiled
    chunked = pcore.run_sweep_chunked(
        praft.workload(pcfg), pecfg, seeds, chunk_size=10, device="cpu", params=pparams
    )
    assert_leaves_equal(state_io.to_numpy_leaves(port), state_io.to_numpy_leaves(chunked),
                        "chunked")


def test_state_bytes_and_pick_chunk_size_equal(tiled):
    (cfg, ecfg, pcfg, pecfg, _s, rparams, pparams), *_ = tiled
    one_r = jax.tree.map(lambda a: np.asarray(a)[0], rparams)
    one_p = tree.map(lambda a: a[0], pparams)
    rwl, pwl = rraft.workload(cfg), praft.workload(pcfg)
    assert pcore.state_bytes_per_seed(pwl, pecfg, params=one_p) == rcore.state_bytes_per_seed(
        rwl, ecfg, params=one_r)
    assert pcore.pick_chunk_size(pwl, pecfg, params=one_p) == (
        rcore.pick_chunk_size(rwl, ecfg, budget_bytes=None, params=one_r))
    for budget in (1 << 20, 1 << 30):
        assert pcore.pick_chunk_size(pwl, pecfg, budget_bytes=budget, params=one_p) == (
            rcore.pick_chunk_size(rwl, ecfg, budget_bytes=budget, params=one_r))
    _w, fcfg, fecfg = __graft_entry__._flagship(tiny=True)
    assert pcore.pick_chunk_size(praft.workload(port_cfg(fcfg)), port_ecfg(fecfg)) == (
        rcore.pick_chunk_size(rraft.workload(fcfg), fecfg))
    assert pcore.DEFAULT_CHUNK_BUDGET_BYTES == rcore.DEFAULT_CHUNK_BUDGET_BYTES


def test_run_traced_identical_through_envelope():
    """A FixedFaults candidate replayed as params through a width-8
    envelope equals the reference's replay, and the port's static
    FixedFaults replay (the shrink channel)."""
    base, _ = amnesia_raft_config()
    fx = rfaults.FixedFaults(events=((300_000_000, "crash", 0), (500_000_000, "restart", 0)))
    env = rfaults.FaultEnvelope(fixed=8)
    kw = dict(time_limit_ns=1_000_000_000, max_steps=8_000)
    traces = []
    for faults, params in ((fx, None), (env, rfaults.spec_to_params(fx, env, base.num_nodes))):
        cfg = base._replace(faults=faults)
        ecfg = rraft.engine_config(cfg, **kw)
        rfinal, rtrace = rcore.run_traced(rraft.workload(cfg), ecfg, 3, params=params)
        pparams = None if params is None else pfaults.spec_to_params(
            port_spec(fx), port_spec(env), base.num_nodes)
        pfinal, ptrace = pcore.run_traced(praft.workload(port_cfg(cfg)), port_ecfg(ecfg), 3,
                                          device="cpu", params=pparams)
        assert_leaves_equal(ref_leaves(rfinal), state_io.to_numpy_leaves(pfinal), "traced")
        assert sorted(ptrace) == sorted(rtrace)
        for k in rtrace:
            np.testing.assert_array_equal(np.asarray(rtrace[k]), ptrace[k].numpy(), err_msg=k)
        traces.append(ptrace)
    for k in traces[0]:
        np.testing.assert_array_equal(traces[0][k].numpy(), traces[1][k].numpy(), err_msg=k)


def test_fixed_faults_raft_sweep_equal():
    base, _ = amnesia_raft_config()
    fx = rfaults.FixedFaults(events=((200_000_000, "crash", 1), (260_000_000, "pause", 2),
                                     (400_000_000, "restart", 1), (500_000_000, "resume", 2),
                                     (600_000_000, "spike_on", 0), (700_000_000, "spike_off", 0)))
    cfg = base._replace(faults=fx)
    ecfg = rraft.engine_config(cfg, time_limit_ns=1_000_000_000, max_steps=8_000)
    seeds = np.arange(16, dtype=np.int64)
    ref = rcore.run_sweep(rraft.workload(cfg), ecfg, seeds)
    port = pcore.run_sweep(praft.workload(port_cfg(cfg)), port_ecfg(ecfg), seeds, device="cpu")
    assert_leaves_equal(ref_leaves(ref), state_io.to_numpy_leaves(port), "FixedFaults")


# -- the legacy queue layout ---------------------------------------------------


def test_legacy_queue_flagship_every_leaf_equal():
    """``legacy_queue=1`` on a 64-seed tiny flagship: the valid plane
    rides in the state (a fourth queue leaf) and every leaf equals the
    reference, which equals the default layout's schedule."""
    _wl, cfg, ecfg = __graft_entry__._flagship(tiny=True)
    ecfg = ecfg._replace(legacy_queue=1)
    seeds = np.arange(64, dtype=np.int64)
    ref = rcore.run_sweep(rraft.workload(cfg), ecfg, jnp.asarray(seeds))
    pcfg, pecfg = port_cfg(cfg), port_ecfg(ecfg)
    port = pcore.run_sweep(praft.workload(pcfg), pecfg, seeds, device="cpu")
    assert_leaves_equal(ref_leaves(ref), state_io.to_numpy_leaves(port), "legacy")
    valid = port.queue.valid
    assert torch.equal(valid, port.queue.time != INVALID_TIME)
    flat = pcore.run_sweep(praft.workload(pcfg), pecfg._replace(legacy_queue=0), seeds,
                           device="cpu")
    assert praft.sweep_summary(flat) == praft.sweep_summary(port)
