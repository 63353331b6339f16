"""``chip_smoke.py`` phase 13 rehearsed on the CPU at the rehearsal size
of its golden file: the stream equals the chunked driver and the golden
totals, its warmed call counts no compile, the checked sweep's two
drivers give the golden report, and an interrupted stream resumes to
the uninterrupted totals; no kernel launches on the CPU."""

import torch

import chip_smoke


def test_stream_phase_on_the_plain_path():
    out = chip_smoke.phase_stream(torch.device("cpu"), run=chip_smoke.STREAM_RUNS[1],
                                  pool=chip_smoke.STREAM_POOL[1], workers=2)
    assert out["launches"] == 0 and out["steps"] > 0
    assert out["rounds"] > 0 and 0 < out["occupancy_mean"] <= 1
    assert out["report"]["hist_violations"] > 0
