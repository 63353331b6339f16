"""``chip_smoke.py`` phase 18 rehearsed on the CPU at the rehearsal sizes
of its goldens: (a) the differential's first gate spec over phase 16
(c)'s rehearsal host seeds (16 at 1 s, the smallest grid
``differential_host.json`` holds) on the port's compiled core and, in a
fresh interpreter under ``MADSIM_NO_NATIVE=1`` that imports no torch,
without it, both equal to the golden; (b) ``rng.event_bits`` of 64
seed keys at the four counters against the native threefry, word for
word; (c) the shim programs over 8 seeds against ``host_shims.json``."""

import torch

import chip_smoke


def test_native_phase_on_the_plain_path():
    out = chip_smoke.phase_native(
        torch.device("cpu"), host=chip_smoke.NATIVE_HOST_RUNS[1],
        lanes=chip_smoke.NATIVE_DRAW_LANES[1], shim_seeds=chip_smoke.SHIM_RUNS[1])
    assert out["core_seeds_per_s"] > 0 and out["python_seeds_per_s"] > 0
    assert out["draw_words"] == 64 * len(chip_smoke.NATIVE_CTRS) * chip_smoke.NATIVE_DRAW_WORDS
    assert sorted(out["shims"]) == sorted(chip_smoke.shim_programs().SMOKE)
    assert set(out["seconds"]) == {"a", "b", "c"}
