"""``chip_smoke.py`` phase 19 rehearsed on the CPU at the rehearsal sizes
of its goldens: one ``obs.Telemetry`` handle (journal, trace, a
localhost ``/metrics`` endpoint scraped from a thread) through (a) the
stale-read checked sweep at 32 seeds in chunks of 16 against
``etcd_checked_stale.json``, (b) the same cell on ``driver="stream"``
with ``stream_rounds_total`` equal to the driver's rounds, (c) the raft
sweep with the event-mix plane against ``obs_event_mix.json``; then (d)
the real-mode programs over localhost against ``real_outcomes.json``. No
kernel launches on the CPU."""

import torch

import chip_smoke


def test_obs_phase_on_the_plain_path():
    out = chip_smoke.phase_obs(torch.device("cpu"), stale=chip_smoke.STALE_RUNS[1],
                               mix=chip_smoke.EVENT_MIX_RUNS[1], workers=2,
                               reps=chip_smoke.REAL_REPS[1], off_wall_s=1.0)
    assert out["launches"] == 0 and out["steps"] > 0
    assert out["a"]["scrapes"] >= 1 and out["a"]["report"]["hist_violations"] > 0
    assert out["b"]["rounds"] > 0 and out["overlap_us"] > 0
    assert sum(out["c"]["event_mix"]) > 0
    assert sorted(out["d"]) == sorted(chip_smoke.real_programs().SMOKE)
    assert set(out["seconds"]) == {"a", "b", "c", "d"}
