"""``chip_smoke.py`` phases 14-15 rehearsed on the CPU, on gloo worlds of
spawned CPU ranks, at the rehearsal sizes of their golden files: the
checked etcd sweep on 1 and 2 ranks equals phase 9's golden report, the
flagship sharded over 2 ranks its golden summary; ``dryrun_multichip(2)``
passes on a world the phase counts on, and ``sharded_campaign`` of the
amnesia gate on 2 ranks writes the golden report's bytes; no kernel
launches on the CPU."""

import torch

import chip_smoke


def test_mesh_phase_on_the_plain_path():
    out = chip_smoke.phase_mesh(torch.device("cpu"), run=chip_smoke.MESH_RUNS[1], workers=2)
    assert out["launches"] == 0 and out["steps"] > 0
    assert sorted(out["walls"]) == list(chip_smoke.MESH_WORLDS)


def test_campaign_phase_on_the_plain_path():
    out = chip_smoke.phase_campaign(torch.device("cpu"), curve=chip_smoke.CURVE_RUNS[1],
                                    run=chip_smoke.CAMPAIGN_RUNS[1])
    assert out["launches"] == 0 and out["steps"] > 0
    assert out["metrics"]["rounds"] == chip_smoke.CAMPAIGN_RUNS[1][0]
    assert out["metrics"]["violations_total"] > 0
