"""Port parity: the fleet orchestrator
(``madsim_tpu_torch.explore.orchestrator``) — the port's counterpart of the
end-to-end case of ``tests/test_fleet.py`` and of ``scripts/fleet_smoke.py``.

Drills of 2 units of 2 candidates. The uniform drill is ``chip_smoke.py``
phase 16 (b)'s rehearsal (fleet_smoke's target and plan at 8 seeds a
candidate), so the reference's merged report is held to that phase's
golden here, and ``tests/test_torch_chip_smoke_explore.py`` holds the
port's one worker and its pair of worker processes to the same golden.
Here the port's merged report equals the reference's byte for byte
after two workers (``max_units=1`` each) of which the first reclaims a
dead worker's expired lease and skips its torn record. The steered
drill (``scheduler="bandit"``, one unit a generation) runs the amnesia
campaign target with its election history recorded, so its stored bugs
carry their canonical history's sha. The port's ``regression_gate``
passes on both stores the reference wrote, and the reference reads the
port's store to the same merged view."""

import os
import time

import pytest

import madsim_tpu.engine  # noqa: F401  (the reference's int64 mode)
from madsim_tpu import explore as rexplore
from madsim_tpu.engine.faults import FaultSpec as RSpec
from madsim_tpu.explore import orchestrator as rorch
from madsim_tpu_torch import explore as pexplore
from madsim_tpu_torch.engine.faults import FaultSpec as PSpec
from madsim_tpu_torch.explore import orchestrator as porch

import _torch_mesh_jobs as jobs
import chip_smoke

UNITS = chip_smoke.FLEET_UNITS
RUN = chip_smoke.FLEET_RUNS[1]
# the steered drill: fleet_smoke's plan shape (campaign seed 7, batch 2)
# at 8 seeds a candidate, one recorded seed and two shrink replays, on
# the violating 3-crash spec of the campaign tests' target. Its seeds end
# within 200 events, so a cap of 1,000 steps changes no lane and spares
# the reference's traced replays (a scan of max_steps) 9,000 frozen steps
STEERED = dict(seeds_per_round=8, batch=2, chunk_size=8, campaign_seed=7, max_recorded_seeds=1,
               scheduler="bandit")
STEERED_TARGET = dict(jobs.AMNESIA, max_steps=1_000)
STEERED_SHRINK_TESTS = 2


def _uniform(pkg, spec_cls):
    return chip_smoke.fleet_setup(pkg, spec_cls, RUN)


def _steered(pkg, spec_cls):
    return (pkg.amnesia_raft_target(**STEERED_TARGET), spec_cls(**jobs.VIOLATING),
            pkg.CampaignConfig(**STEERED))


def _ref_run(root, setup):
    target, base, ccfg = setup(rexplore, RSpec)
    shrink_tests = RUN[2] if setup is _uniform else STEERED_SHRINK_TESTS
    rexplore.run_worker(target, base, ccfg, rexplore.CorpusStore(root, worker="solo"), UNITS,
                        shrink_tests=shrink_tests, steer_cfg=rexplore.SteerConfig(gen_units=1))
    return rexplore.merged_report(rexplore.CorpusStore(root, worker="report"))


def _port_run(root, worker, setup, **kw):
    target, base, ccfg = setup(pexplore, PSpec)
    shrink_tests = RUN[2] if setup is _uniform else STEERED_SHRINK_TESTS
    return pexplore.run_worker(target, base, ccfg, pexplore.CorpusStore(root, worker=worker),
                               UNITS, shrink_tests=shrink_tests,
                               steer_cfg=pexplore.SteerConfig(gen_units=1), device="cpu", **kw)


def _port_report(root):
    return pexplore.merged_report(pexplore.CorpusStore(root, worker="report"))


@pytest.fixture(scope="module")
def ref_uniform(tmp_path_factory):
    """The reference's one-worker uniform drill: (its store's root, its
    merged report)."""
    root = str(tmp_path_factory.mktemp("ref_uniform"))
    return root, _ref_run(root, _uniform)


@pytest.fixture(scope="module")
def ref_steered(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ref_steered"))
    return root, _ref_run(root, _steered)


def test_plan_and_replay_envelope_equal_reference():
    for seed in (7, 11):
        for unit in range(4):
            ccfg = dict(batch=3, campaign_seed=seed)
            got = porch.plan_unit(PSpec(**jobs.AMNESIA_BASE), pexplore.CampaignConfig(**ccfg), unit)
            want = rorch.plan_unit(RSpec(**jobs.AMNESIA_BASE), rexplore.CampaignConfig(**ccfg), unit)
            assert [pexplore.spec_to_dict(s) for s in got] == \
                [rexplore.spec_to_dict(s) for s in want]
    assert porch.plan_unit(PSpec(), pexplore.CampaignConfig(batch=2), 0)[0] == PSpec()
    for n in (0, 1, 4, 5, 9, 64, 65):
        assert porch._pow2_env(n)._asdict() == rorch._pow2_env(n)._asdict()


def test_reference_drill_is_the_rehearsal_golden(ref_uniform):
    """The reference's one-worker report is phase 16 (b)'s rehearsal
    golden, the report the port's solo worker and pair are held to."""
    want = ref_uniform[1]
    golden = chip_smoke.load_golden(chip_smoke.FLEET_GOLDEN)["runs"][chip_smoke.fleet_key(RUN)]
    assert want == golden["report"]
    assert want.count('"kind": "cand"') == UNITS * 2 and '"kind": "bug"' in want


def test_two_workers_with_a_reclaim_merge_to_the_reference(ref_uniform, tmp_path):
    """A worker died holding unit 0 (its lease expired, a torn half-record
    on its log); two port workers with ``max_units=1`` each then split the
    units — the first reclaims unit 0 — and the store merges to the
    reference's one-worker report; the reference reads the port's store
    to the same merged view as its own."""
    root = str(tmp_path / "two")
    dead = pexplore.CorpusStore(root, worker="dead")
    lease = dead.try_lease(0)
    with open(dead._log_path, "a") as f:
        f.write('{"kind": "cand", "key": "000000/00", "payl')
    old = time.time() - 1000
    os.utime(lease.path, (old, old))
    first = _port_run(root, "w0", _uniform, max_units=1, skip_gate=True)
    second = _port_run(root, "w1", _uniform, max_units=1, skip_gate=True)
    assert (first["units"], second["units"]) == ([0], [1])
    assert first["fingerprints"] or second["fingerprints"]
    assert _port_report(root) == ref_uniform[1]
    _, stats = pexplore.CorpusStore(root, worker="r").read_records()
    assert (stats.quarantined, stats.truncated_logs) == (0, 1)
    assert rexplore.CorpusStore(root, worker="r").merged() == \
        rexplore.CorpusStore(ref_uniform[0], worker="r").merged()


def test_steered_generations_merge_to_the_reference(ref_steered, tmp_path):
    """``scheduler="bandit"`` with one unit per generation: unit 1's plan
    comes from the stats of unit 0's stored records; the merged report,
    family keys and history shas included, equals the reference's."""
    res = _port_run(str(tmp_path / "port"), "solo", _steered)
    assert res["units"] == list(range(UNITS))
    got = _port_report(str(tmp_path / "port"))
    assert got == ref_steered[1]
    assert got.count('"family": "') >= UNITS * 2 and '"history_sha": "' in got


@pytest.mark.parametrize("which", ["uniform", "steered"])
def test_regression_gate_passes_on_the_reference_store(ref_uniform, ref_steered, which):
    """Every bug the reference stored replays in the port to its
    fingerprint (and, on the steered drill's history target, its
    canonical history's sha)."""
    root = (ref_uniform if which == "uniform" else ref_steered)[0]
    target = (_uniform if which == "uniform" else _steered)(pexplore, PSpec)[0]
    gate = porch.regression_gate(pexplore.CorpusStore(root, worker="gate"), target, device="cpu")
    assert gate["ok"], gate["mismatches"]
    assert gate["checked"] >= 1 and gate["skipped"] == 0
