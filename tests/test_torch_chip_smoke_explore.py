"""``chip_smoke.py`` phase 16 rehearsed on the CPU at the rehearsal sizes
of its golden files: the steered campaign's report and trace equal the
JAX-made golden's, the fleet drill's solo and pair merged reports equal
each other and the golden, the regression gate passes over the JAX
package's store, and the differential's report and device grid equal
theirs, its host half computed live on the port's host runtime and
equal to ``differential_host.json``; no kernel launches on the CPU, and
the replays are counted."""

import torch

import chip_smoke


def test_explore_phase_on_the_plain_path():
    out = chip_smoke.phase_explore(
        torch.device("cpu"), steer=chip_smoke.STEER_RUNS[1], fleet=chip_smoke.FLEET_RUNS[1],
        diff=chip_smoke.DIFF_RUNS[1], grid=chip_smoke.DIFF_GRID_RUNS[1])
    assert out["launches"] == 0 and out["steps"] > 0
    assert out["steer"]["decisions"] > 0 and out["steer"]["replays"]["calls"] > 0
    assert sorted(u for w in out["fleet"]["pair"] for u in w["units"]) == \
        list(range(chip_smoke.FLEET_UNITS))
    assert out["fleet"]["solo"]["replay_steps"] > 0 and out["fleet"]["solo"]["shrink"]["calls"] > 0
    assert out["fleet"]["gate"]["ok"] and out["fleet"]["gate"]["checked"] >= 1
    assert out["differential"]["host_seeds_per_s"] > 0  # the host half ran live
