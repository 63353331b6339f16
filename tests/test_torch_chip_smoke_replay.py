"""``chip_smoke.py`` phase 17 rehearsed on the CPU at a small width: the
amnesia sweep over 64 lanes (the golden's violating seeds among them),
``run_traced`` of the second violating seed equal on the "card" (here
the CPU) and the CPU, its plan equal to ``compile_host`` and the golden's,
and ``replay_on_host`` on the port's host runtime equal to the golden's
reproduction; no kernel launches on the CPU, and the replay is counted."""

import torch

import chip_smoke


def test_cross_tier_phase_on_the_plain_path():
    out = chip_smoke.phase_cross_tier(torch.device("cpu"), seeds=chip_smoke.REPLAY_RUNS[1])
    assert out["launches"] == 0 and out["steps"] > 0
    golden = chip_smoke.load_golden(chip_smoke.REPLAY_GOLDEN)
    assert out["host"] == golden["host"] and out["host"]["violations"] > 0
    assert set(out["seconds"]) == {"a", "b", "c"}
