"""The golden campaign report the port checks itself against on the card.

``madsim_tpu_torch/data/campaign_amnesia.json`` holds the JAX reference's
``explore.run_campaign`` JSONL report (its text and sha256) of the amnesia
gate (``explore.targets.amnesia_gate(smoke=False)``) at the
``CampaignConfig`` sizes ``chip_smoke.py`` phase 15 runs on the card and
its CPU rehearsal runs, and under ``curves`` the report sha256 per world
size of ``explore.checked_sweep_curve`` of the smoke gate at the sizes of
phase 15's dry run (the reference's own ``hist_unique`` is a per-chunk
count, so those reports may differ between world sizes). The reference runs unsharded: its report bytes
are the same on any mesh size. This test recomputes the rehearsal-sized
report with ``madsim_tpu`` (the card-sized one behind ``slow``), so the
file cannot go stale. Regenerate with
``JAX_PLATFORMS=cpu python tests/test_torch_campaign_golden.py --write``
(about 2 min).
"""

import hashlib
import json
import os
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from _torch_parity import reference_curve  # noqa: E402


def reference_report(rounds: int, seeds_per_round: int, chunk_size: int) -> str:
    from madsim_tpu.explore import CampaignConfig, run_campaign
    from madsim_tpu.explore.targets import amnesia_gate

    target, base = amnesia_gate(smoke=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "campaign.jsonl")
        run_campaign(target, base, CampaignConfig(
            rounds=rounds, seeds_per_round=seeds_per_round, chunk_size=chunk_size),
            report_path=path)
        with open(path) as f:
            return f.read()


def _golden() -> dict:
    return chip_smoke.load_golden(chip_smoke.CAMPAIGN_GOLDEN)


def test_golden_holds_what_chip_smoke_runs():
    golden = _golden()
    assert golden["config"] == chip_smoke.campaign_golden_config()
    assert sorted(golden["reports"]) == sorted(
        chip_smoke.campaign_key(*run) for run in chip_smoke.CAMPAIGN_RUNS)
    for run in chip_smoke.CAMPAIGN_RUNS:
        rep = golden["reports"][chip_smoke.campaign_key(*run)]
        assert hashlib.sha256(rep["jsonl"].encode()).hexdigest() == rep["sha256"]
        records = [json.loads(line) for line in rep["jsonl"].splitlines()[1:]]
        assert len(records) == run[0]
        assert sum(r["violations"] for r in records) > 0


def test_golden_holds_the_curves_chip_smoke_runs():
    curves = _golden()["curves"]
    assert sorted(curves) == sorted(chip_smoke.curve_key(*c[:2]) for c in chip_smoke.CURVE_RUNS)
    for c in curves.values():
        assert sorted(c["report_sha256"]) == ["1", "2"]
        assert c["bytes_invariant"] == (len(set(c["report_sha256"].values())) == 1)


def test_golden_rehearsal_curve_is_the_reference():
    run = chip_smoke.CURVE_RUNS[1]
    assert reference_curve(*run[:2]) == _golden()["curves"][chip_smoke.curve_key(*run[:2])]


@pytest.mark.slow
def test_golden_card_curve_is_the_reference():
    run = chip_smoke.CURVE_RUNS[0]
    assert reference_curve(*run[:2]) == _golden()["curves"][chip_smoke.curve_key(*run[:2])]


def test_golden_rehearsal_report_is_the_reference():
    run = chip_smoke.CAMPAIGN_RUNS[1]
    assert reference_report(*run) == _golden()["reports"][chip_smoke.campaign_key(*run)]["jsonl"]


@pytest.mark.slow
def test_golden_card_report_is_the_reference():
    run = chip_smoke.CAMPAIGN_RUNS[0]
    assert reference_report(*run) == _golden()["reports"][chip_smoke.campaign_key(*run)]["jsonl"]


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_campaign_golden.py --write")
    # the curve's reference needs two CPU devices, as under the tests' conftest
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    reports = {}
    for run in chip_smoke.CAMPAIGN_RUNS:
        text = reference_report(*run)
        reports[chip_smoke.campaign_key(*run)] = {
            "jsonl": text, "sha256": hashlib.sha256(text.encode()).hexdigest()}
    curves = {chip_smoke.curve_key(*c[:2]): reference_curve(*c[:2])
              for c in chip_smoke.CURVE_RUNS}
    path = chip_smoke.data_path(chip_smoke.CAMPAIGN_GOLDEN)
    with open(path, "w") as f:
        json.dump({"config": chip_smoke.campaign_golden_config(), "reports": reports,
                   "curves": curves}, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {path}")
