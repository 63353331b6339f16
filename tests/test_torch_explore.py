"""Port parity: the coverage-guided campaign loop
(``madsim_tpu_torch.explore``: targets, triage, shrink, campaign, fleet)
and the replay helpers (``madsim_tpu_torch.replay``) — the port's
counterparts of ``tests/test_explore.py`` and the campaign legs of
``tests/test_parallel.py``.

Each is held to the reference on the same inputs, exactly: the mutation
sequences of one ``random.Random`` seed, the gate targets' configs,
``compile_host`` and ``extract_fault_schedule``, ``triage_seed``'s
``Failure`` (probe and history flavors) and ``shrink``'s
``ShrinkResult`` on an amnesia seed, and ``sweep_candidate_grid``'s
summaries unsharded and on a 2-rank gloo world of spawned CPU ranks
(``parallel.World``). The campaign's reports and the world-size curve
are in ``tests/test_torch_campaign.py``."""

import functools
import random

import pytest

import madsim_tpu.engine  # noqa: F401  (the reference's int64 mode)
from madsim_tpu import explore as rexplore
from madsim_tpu import faults as rhostfaults
from madsim_tpu import replay as rreplay
from madsim_tpu.engine import core as rcore
from madsim_tpu.engine.faults import FaultSpec as RSpec
from madsim_tpu.engine.faults import FixedFaults as RFixed
from madsim_tpu.explore import targets as rtargets
from madsim_tpu_torch import explore as pexplore
from madsim_tpu_torch import replay as preplay
from madsim_tpu_torch.engine import core as pcore
from madsim_tpu_torch.engine.faults import FaultSpec as PSpec
from madsim_tpu_torch.engine.faults import FixedFaults as PFixed
from madsim_tpu_torch.explore import targets as ptargets

import _torch_mesh_jobs as jobs
from _torch_parity import worlds

world = pytest.fixture(scope="module")(worlds)

BLAND = dict(crashes=1, crash_window_ns=2_000_000_000,
             restart_lo_ns=50_000_000, restart_hi_ns=300_000_000)
VIOLATING = jobs.VIOLATING
VIOLATING_SEED = jobs.VIOLATING_SEED


# triage and shrink replay one seed through run_traced, whose trace (the
# reference's scan) is max_steps long: the violating seed ends within 110
# events, so a cap of 1,000 steps changes no replay and spares the
# reference 9,000 frozen steps a replay
TRIAGE = dict(jobs.AMNESIA, max_steps=1_000)


def ref_target(**kw):
    return rtargets.amnesia_raft_target(**dict(jobs.AMNESIA, **kw))


def port_target(**kw):
    return ptargets.amnesia_raft_target(**dict(jobs.AMNESIA, **kw))


# -- mutation and the spec encoding -------------------------------------------


@pytest.mark.parametrize("rng_seed", [0, 1, 42])
def test_mutation_sequences_equal_reference(rng_seed):
    """One ``random.Random`` seed drives the same 60 chained mutations in
    both packages; every candidate encodes to the same dict and
    round-trips."""
    r_rng, p_rng = random.Random(rng_seed), random.Random(rng_seed)
    r_spec, p_spec = RSpec(**BLAND), PSpec(**BLAND)
    for i in range(60):
        r_spec = rexplore.mutate_spec(r_spec, r_rng, mutations_hi=3)
        p_spec = pexplore.mutate_spec(p_spec, p_rng, mutations_hi=3)
        assert pexplore.spec_to_dict(p_spec) == rexplore.spec_to_dict(r_spec), i
        assert pexplore.spec_from_dict(pexplore.spec_to_dict(p_spec)) == p_spec
    assert p_rng.random() == r_rng.random()  # the streams drew alike


def test_fixed_faults_encoding_equals_reference():
    events = ((5, "crash", 0), (9, "restart", 0), (12, "partition", 2))
    r, p = RFixed(events=events), PFixed(events=events)
    assert pexplore.spec_to_dict(p) == rexplore.spec_to_dict(r)
    assert pexplore.spec_from_dict(rexplore.spec_to_dict(r)) == p


@pytest.mark.parametrize("name", ["amnesia_gate", "steer_gate", "etcd_steer_gate"])
@pytest.mark.parametrize("smoke", [True, False])
def test_gate_targets_equal_reference(name, smoke):
    """The gates build the same configs in both packages."""
    rt, rbase = getattr(rtargets, name)(smoke)
    pt, pbase = getattr(ptargets, name)(smoke)
    assert pbase._asdict() == rbase._asdict()
    assert (pt.name, pt.num_nodes, pt.fault_kind) == (rt.name, rt.num_nodes, rt.fault_kind)
    (_, recfg), (_, pecfg) = rt.build(rbase), pt.build(pbase)
    assert pecfg._asdict() == recfg._asdict()
    assert (pt.hist_spec is None) == (rt.hist_spec is None)


# -- replay helpers -------------------------------------------------------------


def test_replay_helpers_equal_reference():
    """``amnesia_raft_config`` and ``compile_host`` (the schedule of a
    seed, derived on the CPU) equal the reference's."""
    rcfg, recfg = rreplay.amnesia_raft_config()
    pcfg, pecfg = preplay.amnesia_raft_config()
    assert pecfg._asdict() == recfg._asdict()
    for f in ("num_nodes", "crashes", "commands", "volatile_state", "crash_window_ns"):
        assert getattr(pcfg, f) == getattr(rcfg, f)
    spec = dict(crashes=2, partitions=1, spikes=1, losses=1, pauses=1, aparts=1, skews=1)
    for seed in (0, 7, 2**40 + 3):
        assert preplay.compile_host(PSpec(**spec), 5, seed) == \
            rhostfaults.compile_host(RSpec(**spec), 5, seed)
    fixed = ((30, "restart", 1), (10, "crash", 1))
    assert preplay.compile_host(PFixed(events=fixed), 3, 0) == \
        rhostfaults.compile_host(RFixed(events=fixed), 3, 0)


# -- triage and shrink ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def ref_triaged(history):
    return rexplore.triage_seed(ref_target(**TRIAGE), RSpec(**VIOLATING), VIOLATING_SEED,
                                history=history)


@pytest.mark.parametrize("history", [False, True], ids=["probe", "history"])
def test_triage_seed_equals_reference(history):
    want = ref_triaged(history)
    got = pexplore.triage_seed(port_target(**TRIAGE), PSpec(**VIOLATING), VIOLATING_SEED,
                               history=history, device="cpu")
    assert want is not None and tuple(got) == tuple(want)
    assert type(got).__name__ == "Failure"


def test_fault_schedule_of_a_trace_equals_reference():
    """``extract_fault_schedule`` of the violating seed's replay equals
    the reference's, and its events are ``compile_host``'s (all fire
    inside the horizon)."""
    rwl, recfg = ref_target(**TRIAGE).build(RSpec(**VIOLATING))
    pwl, pecfg = port_target(**TRIAGE).build(PSpec(**VIOLATING))
    _, rtrace = rcore.run_traced(rwl, recfg, VIOLATING_SEED)
    _, ptrace = pcore.run_traced(pwl, pecfg, VIOLATING_SEED, device="cpu")
    got = preplay.extract_fault_schedule(ptrace, ptargets.amnesia_raft_target().fault_kind)
    assert got == rreplay.extract_fault_schedule(rtrace, rtargets.amnesia_raft_target().fault_kind)
    assert got and got == preplay.compile_host(PSpec(**VIOLATING), 3, VIOLATING_SEED)


def test_shrink_equals_reference():
    """``shrink``'s minimal ``FixedFaults`` triple, its fingerprint, its
    failure and its replay count equal the reference's."""
    want = rexplore.shrink(ref_target(**TRIAGE), RSpec(**VIOLATING), VIOLATING_SEED,
                           max_tests=4)
    got = pexplore.shrink(port_target(**TRIAGE), PSpec(**VIOLATING), VIOLATING_SEED,
                          max_tests=4, device="cpu")
    assert want is not None and got is not None
    assert pexplore.spec_to_dict(got.spec) == rexplore.spec_to_dict(want.spec)
    assert (got.seed, got.schedule, got.fingerprint, got.tests, got.original_len) == \
        (want.seed, want.schedule, want.fingerprint, want.tests, want.original_len)
    assert tuple(got.failure) == tuple(want.failure)
    narrowed = pexplore.narrow_windows(PSpec(**VIOLATING), got.schedule)
    assert narrowed._asdict() == rexplore.narrow_windows(RSpec(**VIOLATING),
                                                         want.schedule)._asdict()


def test_bandit_scheduler_is_not_ported():
    """The ``scheduler="bandit"`` route is ported (the name is the one
    this test had while it pinned the refusal): one steered decision
    through ``run_campaign`` gives the reference's result; an unknown
    scheduler still raises. The steered runs' bytes are
    ``tests/test_torch_steer.py``'s."""
    ccfg = dict(rounds=1, seeds_per_round=8, chunk_size=8, scheduler="bandit")
    want = rexplore.run_campaign(ref_target(), RSpec(**BLAND), rexplore.CampaignConfig(**ccfg))
    got = pexplore.run_campaign(port_target(), PSpec(**BLAND), pexplore.CampaignConfig(**ccfg),
                                device="cpu")
    assert (got.records, got.coverage_map) == (want.records, want.coverage_map)
    assert len(got.records) == 1 and got.records[0]["family"] == "001"
    with pytest.raises(ValueError, match="scheduler"):
        pexplore.run_campaign(port_target(), PSpec(**BLAND),
                              pexplore.CampaignConfig(rounds=1, scheduler="greedy"), device="cpu")


GRID = dict(seeds_per_round=64, chunk_size=64)
GRID_SPECS = [jobs.AMNESIA_BASE, VIOLATING]


@functools.lru_cache(maxsize=None)
def ref_grid():
    target = ref_target()
    return rexplore.sweep_candidate_grid(
        target, [RSpec(**s) for s in GRID_SPECS], rexplore.CampaignConfig(**GRID),
        rexplore.target_envelope(target, RSpec(**jobs.AMNESIA_BASE)))


@pytest.mark.parametrize("n", [None, 2])
def test_sweep_candidate_grid_equals_reference(world, n):
    """The (candidate x seed) grid through the stream, unsharded and on 2
    ranks: each candidate's summary equals the reference's."""
    if n is None:
        target = port_target()
        got = pexplore.sweep_candidate_grid(
            target, [PSpec(**s) for s in GRID_SPECS], pexplore.CampaignConfig(**GRID),
            pexplore.target_envelope(target, PSpec(**jobs.AMNESIA_BASE)), device="cpu")
    else:
        got = world(n, jobs.grid, GRID, GRID_SPECS)
    assert got == ref_grid()
