"""``chip_smoke.py`` phases 10-12 rehearsed on the CPU at the rehearsal
sizes of their golden files: the kafka and S3 sweeps and the checked
kafka sweep equal the JAX-made goldens, the parity and replay checks
pass, and no kernel launches on the CPU."""

import torch

import chip_smoke

CPU = torch.device("cpu")


def test_kafka_phase_on_the_plain_path():
    out = chip_smoke.phase_kafka(CPU, seeds=chip_smoke.KAFKA_RUNS[1], parity_seeds=8)
    assert out["launches"] == 0 and out["steps"] > 0
    assert out["summary"]["seeds"] == chip_smoke.KAFKA_RUNS[1]


def test_s3_phase_on_the_plain_path():
    out = chip_smoke.phase_s3(CPU, seeds=chip_smoke.S3_RUNS[1],
                              bug_seeds=chip_smoke.S3_BUG_RUNS[1], parity_seeds=8)
    assert out["launches"] == 0 and out["steps"] > 0
    assert out["bug"]["summary"]["violations"] > 0 == out["clean"]["summary"]["violations"]


def test_checked_kafka_phase_on_the_plain_path():
    out = chip_smoke.phase_kafka_checked(CPU, clean=chip_smoke.KAFKA_CLEAN_RUNS[1],
                                         bug=chip_smoke.KAFKA_BUG_RUNS[1], workers=2)
    assert out["launches"] == 0 and out["steps"] > 0
    assert out["clean"]["report"]["hist_violations"] == 0
    assert out["bug"]["report"]["violations"] > 0
    assert out["clean"]["phases_s"]["sweep_seconds"] > 0
