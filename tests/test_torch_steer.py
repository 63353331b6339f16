"""Port parity: the self-steering scheduler
(``madsim_tpu_torch.explore.steer``) and the ``scheduler="bandit"`` route
of ``run_campaign`` — the port's counterparts of ``tests/test_steer.py``
and the steering runs of ``scripts/steer_demo.py``.

The host layer case by case: the family helpers, the bandit's decision
trace (cold order, exploitation, kills, escalation, the uniform grid)
under one synthetic outcome sequence, the fleet's stats fold and the
steered unit plan — each run through both packages, byte for byte. Then
steered campaigns end to end on the CPU: the raft steer gate at
``pipeline`` 1 and 2 (an escalation in the run), through ``run_steered``
and through ``run_campaign(scheduler="bandit")`` with a telemetry stub,
the etcd steer gate with ``history=True``, and ``run_steered(mesh=)`` on
a 2-rank gloo world (4 ranks under ``slow``): report and decision-trace
bytes equal to the reference's, whose pipeline-2 raft run is also held
to ``chip_smoke.py`` phase 16 (a)'s rehearsal golden."""

import functools
import json
import random

import pytest

import madsim_tpu.engine  # noqa: F401  (the reference's int64 mode)
from madsim_tpu import explore as rexplore
from madsim_tpu.engine.faults import FaultSpec as RSpec
from madsim_tpu.explore import steer as rsteer
from madsim_tpu_torch import explore as pexplore
from madsim_tpu_torch.engine.faults import FaultSpec as PSpec
from madsim_tpu_torch.explore import steer as psteer

import _torch_mesh_jobs as jobs
import chip_smoke
from _torch_parity import worlds

world = pytest.fixture(scope="module")(worlds)

CRASHY = dict(crashes=2, crash_window_ns=1_500_000_000)
UNI = (0x001, 0x002, 0x004)
BASES = [dict(), CRASHY, dict(crashes=1, partitions=2, skews=3),
         dict(spikes=1, losses=2, fsync_stalls=1, power_fails=1)]


def _dicts(pkg, specs):
    return [pkg.spec_to_dict(s) for s in specs]


# -- family keying and mutation chains ---------------------------------------


@pytest.mark.parametrize("base", BASES)
def test_family_helpers_equal_reference(base):
    r, p = RSpec(**base), PSpec(**base)
    assert psteer.family_of(p) == rsteer.family_of(r)
    assert psteer.family_universe(p) == rsteer.family_universe(r)
    for mask in (0x000, 0x001, 0x003, 0x101, 0x1ff):
        assert psteer._mask_spec(p, mask)._asdict() == rsteer._mask_spec(r, mask)._asdict()


def test_family_keys_and_chain_rngs_equal_reference():
    assert [psteer.family_key(m) for m in range(0x200)] == \
        [rsteer.family_key(m) for m in range(0x200)]
    for seed, mask, salt in ((0, 1, 0), (7, 0x003, 0), (7, 0x003, 5), (2**63 + 11, 0x1ff, 2**40)):
        a, b = psteer._chain_rng(seed, mask, salt), rsteer._chain_rng(seed, mask, salt)
        assert [a.random() for _ in range(4)] == [b.random() for _ in range(4)]


@pytest.mark.parametrize("salt", [0, 1, 3])
def test_family_candidates_equal_reference(salt):
    """Chains of every family of the crashy base's universe, lineages 0-3,
    through both packages' mutators."""
    r, p = RSpec(**CRASHY), PSpec(**CRASHY)
    for mask in rsteer.family_universe(r):
        want = [rsteer.family_candidate(r, mask, 7, i, salt=salt) for i in range(4)]
        got = [psteer.family_candidate(p, mask, 7, i, salt=salt) for i in range(4)]
        assert _dicts(pexplore, got) == _dicts(rexplore, want), hex(mask)


# -- the bandit ---------------------------------------------------------------


def _sched(steer, scfg_kw=None, universe=UNI):
    return steer.BanditScheduler(universe, steer.SteerConfig(**(scfg_kw or {})),
                                 seeds_per_play=16, budget_lo=100, budget_hi=200)


def _outcome(rng: random.Random) -> dict:
    """A synthetic outcome: sparse coverage, rare fresh fingerprints,
    violations with duplicate hits."""
    vio = rng.choice((0, 0, 0, 1, 3))
    fresh = rng.choice((0, 0, 1)) if vio else 0
    return {"events": rng.randrange(1, 5000), "new_bits": rng.choice((0, 0, 0, 2, 40)),
            "vio": vio, "fresh": fresh, "dup": max(0, vio - fresh)}


def _drill(steer, scfg_kw, universe, seed=0, decisions=40, pipeline=2):
    """``decisions`` decisions, the outcome of decision i absorbed before
    decision i + pipeline, each from one seeded outcome stream."""
    s = _sched(steer, scfg_kw, universe)
    rng = random.Random(seed)
    pending = [s.decide() for _ in range(pipeline)]
    for _ in range(decisions):
        rec = pending.pop(0)
        s.absorb(int(rec["family"], 16), _outcome(rng))
        pending.append(s.decide())
    return s


@pytest.mark.parametrize("scfg_kw", [
    dict(),
    dict(kill_plays=1),
    dict(kill_plays=2, kill_dup_rate_pct=50, escalate_seeds=3),
    dict(ucb_c_milli=200, fp_bits=8),
    dict(scheduler="uniform", kill_plays=1),
], ids=["defaults", "kill1", "dup-kill", "greedy", "uniform"])
@pytest.mark.parametrize("universe", [UNI, tuple(1 << i for i in range(9)) + (0x003,)],
                         ids=["three", "ten"])
def test_scheduler_trace_equals_reference(scfg_kw, universe):
    """One synthetic outcome sequence through both packages' schedulers:
    the same trace bytes, kills, escalations and stats."""
    want = _drill(rsteer, scfg_kw, universe)
    got = _drill(psteer, scfg_kw, universe)
    assert got.trace_lines() == want.trace_lines()
    assert (got.killed, got.escalated, got.stats, got.spent_events) == \
        (want.killed, want.escalated, want.stats, want.spent_events)
    if scfg_kw.get("scheduler") == "uniform":
        assert not got.killed and not got.escalated
    for line in got.trace_lines().splitlines():
        rec = json.loads(line)
        assert all(type(v) in (int, str, bool) for v in rec.values()), rec


def _scenario(steer):
    """The reference tests' transitions in one run: cold order, a
    barren kill, a dup-saturated kill, an escalation and its hot
    decision."""
    s = _sched(steer, dict(kill_plays=2, kill_dup_rate_pct=90, escalate_seeds=4))
    cold = [s.decide() for _ in range(3)]
    s.absorb(0x001, {"events": 1000, "new_bits": 0, "vio": 0, "fresh": 0, "dup": 0})
    s.absorb(0x002, {"events": 10, "new_bits": 0, "vio": 10, "fresh": 1, "dup": 9})
    s.absorb(0x004, {"events": 10, "new_bits": 5, "vio": 1, "fresh": 1, "dup": 0})
    more = [s.decide() for _ in range(2)]
    s.absorb(0x001, {"events": 1000, "new_bits": 0, "vio": 0, "fresh": 0, "dup": 0})
    s.absorb(0x002, {"events": 10, "new_bits": 0, "vio": 2, "fresh": 0, "dup": 2})
    last = [s.decide() for _ in range(3)]
    return s, cold, more, last


def test_kill_escalate_and_cold_order_equal_reference():
    want, *wrecs = _scenario(rsteer)
    got, cold, more, last = _scenario(psteer)
    assert [cold, more, last] == wrecs and got.trace_lines() == want.trace_lines()
    assert [r["family"] for r in cold] == ["001", "002", "004"]
    assert got.killed == {0x001: "barren", 0x002: "dup-saturated"}
    assert got.escalated == [0x002, 0x004]
    assert all(r["family"] == "004" and r["hot"] and r["seeds"] == 64 and r["budget"] == 200
               for r in last)


def test_last_live_family_is_never_killed():
    runs = []
    for steer in (rsteer, psteer):
        s = _sched(steer, dict(kill_plays=1), universe=(0x001,))
        for _ in range(5):
            s.decide()
            s.absorb(0x001, {"events": 1000, "new_bits": 0, "vio": 0, "fresh": 0, "dup": 0})
        runs.append(s)
    assert not runs[1].killed and runs[1].trace_lines() == runs[0].trace_lines()


def test_scheduler_config_and_refusals_equal_reference():
    assert psteer.SteerConfig()._asdict() == rsteer.SteerConfig()._asdict()
    for bad in (dict(universe=()), dict(scfg_kw=dict(scheduler="greedy"))):
        for steer in (rsteer, psteer):
            with pytest.raises(ValueError):
                _sched(steer, **bad)
    rec = {"kind": "decide", "i": 4, "family": "001"}
    assert psteer._jfields(rec) == rsteer._jfields(rec) and rec["kind"] == "decide"


# -- the fleet's stats fold and the steered unit plan ------------------------


def _cand(unit, cand, fam, cov, vio=0, seeds=(), events=500):
    return (f"{unit:06d}/{cand:02d}",
            {"unit": unit, "cand": cand, "family": fam, "coverage_map": cov,
             "violations": vio, "violating_seeds": list(seeds), "events_total": events})


def _bug(unit, cand, fp):
    return (fp, {"unit": unit, "cand": cand, "fingerprint": fp})


CANDS = [_cand(0, 0, "001", [0b0011], vio=2, seeds=[3, 9]), _cand(0, 1, "002", [0b0100]),
         _cand(1, 0, "001", [0b0011], vio=1, seeds=[5]), _cand(1, 1, "004", [0b1000, 1]),
         (_cand(2, 0, "001", [1])[0], {k: v for k, v in _cand(2, 0, "001", [1])[1].items()
                                       if k != "family"})]
BUGS = [_bug(0, 0, "raft:f1:k2:n1"), _bug(1, 0, "raft:f1:k2:n1"), _bug(1, 1, "raft:f1:k2:n0")]


def test_fold_family_stats_equals_reference():
    want = rsteer.fold_family_stats(CANDS, BUGS)
    assert psteer.fold_family_stats(CANDS, BUGS) == want
    assert psteer.fold_family_stats(CANDS[::-1], BUGS[::-1]) == want
    assert want[0x001]["plays"] == 2 and want[0x001]["dup"] == 2


@pytest.mark.parametrize("unit", [0, 2, 3])
@pytest.mark.parametrize("kill_plays", [1, 3])
def test_plan_unit_steered_equals_reference(unit, kill_plays):
    stats = rsteer.fold_family_stats(CANDS, BUGS)
    plans = []
    for pkg, steer, spec in ((rexplore, rsteer, RSpec), (pexplore, psteer, PSpec)):
        ccfg = pkg.CampaignConfig(seeds_per_round=16, campaign_seed=7, batch=4)
        plan = steer.plan_unit_steered(
            spec(**CRASHY), ccfg, steer.SteerConfig(families=UNI, kill_plays=kill_plays),
            unit, {m: dict(st) for m, st in stats.items()})
        plans.append([(m, pkg.spec_to_dict(s)) for m, s in plan])
    assert plans[1] == plans[0] and len(plans[1]) == 4


# -- steered campaigns end to end --------------------------------------------

FAMILIES = (0x001, 0x002, 0x003, 0x004, 0x008, 0x010, 0x020, 0x040, 0x080, 0x100)
# the steering A/B's cells (bench.py's steering leg) at their seed granule
# of 16, two violating seeds triaged a decision (phase 16's cut): the raft
# gate's budget makes four decisions, one of them escalated; the etcd
# gate's two, both escalated, each triaged through the history checker
RAFT = dict(seeds_per_round=16, budget=6_000, recorded=2)
ETCD = dict(seeds_per_round=16, budget=1_000, recorded=2)


def _configs(pkg, run, pipeline):
    ccfg = pkg.CampaignConfig(rounds=999, seeds_per_round=run["seeds_per_round"],
                              campaign_seed=7, max_recorded_seeds=run["recorded"],
                              scheduler="bandit")
    scfg = pkg.SteerConfig(families=FAMILIES, escalate_seeds=8, kill_plays=1,
                           budget_events=run["budget"], pipeline=pipeline)
    return ccfg, scfg


class Recorder:
    """A telemetry stub with every recorder the campaign and the stream
    call; it keeps the calls."""

    tracer = None

    def __init__(self):
        self.calls = []

    def count(self, name, *args, **kwargs):
        self.calls.append(("count", name, args, kwargs))

    def gauge(self, name, *args, **kwargs):
        self.calls.append(("gauge", name, args, kwargs))

    def observe(self, name, *args, **kwargs):
        self.calls.append(("observe", name, args, kwargs))

    def event(self, name, *args, **kwargs):
        self.calls.append(("event", name, args, kwargs))

    def sample(self, name, *args, **kwargs):
        self.calls.append(("sample", name, args, kwargs))

    def event_mix(self, summary):
        del summary

    def steering(self):
        """The steered loop's own calls, bar the wall-clock gauge."""
        return [c for c in self.calls
                if (c[1].startswith("steer_") or c[1] == "steer_round")
                and c[1] != "steer_time_to_first_bug_seconds"]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def ref_steered(gate, pipeline, tmp):
    """The reference's steered run: (report bytes, trace bytes, result,
    telemetry recorder)."""
    target, base = getattr(rexplore, gate)(smoke=True)
    ccfg, scfg = _configs(rexplore, RAFT if gate == "steer_gate" else ETCD, pipeline)
    rp, tp = f"{tmp}/ref_{gate}_{pipeline}.jsonl", f"{tmp}/ref_{gate}_{pipeline}.trace"
    tel = Recorder()
    res = rexplore.run_steered(target, base, ccfg, scfg, report_path=rp, trace_path=tp,
                               history=gate == "etcd_steer_gate", telemetry=tel)
    return _read(rp), _read(tp), res, tel


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("steer"))


def test_run_steered_equals_reference_at_pipeline_1(tmp):
    want_report, want_trace, want, _ = ref_steered("steer_gate", 1, tmp)
    target, base = pexplore.steer_gate(smoke=True)
    ccfg, scfg = _configs(pexplore, RAFT, 1)
    got = pexplore.run_steered(target, base, ccfg, scfg, report_path=f"{tmp}/p1.jsonl",
                               trace_path=f"{tmp}/p1.trace", device="cpu")
    assert _read(f"{tmp}/p1.jsonl") == want_report
    assert _read(f"{tmp}/p1.trace") == want_trace
    assert (got.decisions, got.fingerprints, got.spent_events, got.records, got.coverage_map) == \
        (want.decisions, want.fingerprints, want.spent_events, want.records, want.coverage_map)
    assert _dicts(pexplore, got.corpus) == _dicts(rexplore, want.corpus)
    assert [(pexplore.spec_to_dict(s), x) for s, x in got.failures] == \
        [(rexplore.spec_to_dict(s), x) for s, x in want.failures]


def test_bandit_campaign_route_equals_reference_with_telemetry(tmp):
    """``run_campaign(scheduler="bandit")`` at pipeline 2 (an escalated
    decision jumps the dispatch queue): the report and trace bytes are
    the reference's, its result is ``run_steered``'s as a
    ``CampaignResult``, and the telemetry stub saw the reference's
    steering calls in the reference's order. This is ``chip_smoke.py``
    phase 16 (a)'s rehearsal config, so the reference's bytes are also
    its golden's (``steer_raft.json``, which the card's run is held to)."""
    want_report, want_trace, want, want_tel = ref_steered("steer_gate", 2, tmp)
    assert any(json.loads(line)["kind"] == "escalate" for line in want_trace.splitlines()[1:])
    run = chip_smoke.STEER_RUNS[1]
    assert run == (RAFT["seeds_per_round"], RAFT["budget"], RAFT["recorded"])
    golden = chip_smoke.load_golden(chip_smoke.STEER_GOLDEN)["runs"][chip_smoke.steer_key(run)]
    assert (golden["report"].encode(), golden["trace"].encode()) == (want_report, want_trace)
    target, base = pexplore.steer_gate(smoke=True)
    ccfg, scfg = _configs(pexplore, RAFT, 2)
    tel = Recorder()
    got = pexplore.run_campaign(target, base, ccfg, report_path=f"{tmp}/p2.jsonl",
                                steer_cfg=scfg, trace_path=f"{tmp}/p2.trace",
                                telemetry=tel, device="cpu")
    assert _read(f"{tmp}/p2.jsonl") == want_report
    assert _read(f"{tmp}/p2.trace") == want_trace
    assert type(got).__name__ == "CampaignResult"
    assert (got.records, got.coverage_map) == (want.records, want.coverage_map)
    assert tel.steering() == want_tel.steering()
    assert any(c[1] == "steer_time_to_first_bug_seconds" for c in tel.calls)


def test_etcd_steered_with_history_equals_reference(tmp):
    want_report, want_trace, want, _ = ref_steered("etcd_steer_gate", 2, tmp)
    target, base = pexplore.etcd_steer_gate(smoke=True)
    ccfg, scfg = _configs(pexplore, ETCD, 2)
    got = pexplore.run_steered(target, base, ccfg, scfg, history=True,
                               report_path=f"{tmp}/e.jsonl", trace_path=f"{tmp}/e.trace",
                               device="cpu")
    assert _read(f"{tmp}/e.jsonl") == want_report
    assert _read(f"{tmp}/e.trace") == want_trace
    assert got.fingerprints == want.fingerprints == ["etcd-stale:history:get"]


@pytest.mark.parametrize("n", [2, pytest.param(4, marks=pytest.mark.slow)])
def test_run_steered_on_a_mesh_equals_the_unsharded_run(world, tmp, n):
    """``run_steered(mesh=)``: every rank makes the reference's decisions;
    rank 0 writes the reference's report and trace bytes."""
    want_report, want_trace, want, _ = ref_steered("steer_gate", 2, tmp)
    rp, tp = f"{tmp}/m{n}.jsonl", f"{tmp}/m{n}.trace"
    got = world(n, jobs.steered, RAFT["seeds_per_round"], RAFT["budget"], RAFT["recorded"],
                FAMILIES, rp, tp)
    assert got == (json.dumps(want.records, sort_keys=True),
                   json.dumps(want.decisions, sort_keys=True))
    assert _read(rp) == want_report and _read(tp) == want_trace
