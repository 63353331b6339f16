"""The golden checked-sweep reports the port checks itself against on the
card.

``madsim_tpu_torch/data/etcd_checked_clean.json`` and
``etcd_checked_stale.json`` hold the JAX reference's
``oracle.screen.checked_sweep`` report of the etcd history workload
(``EtcdConfig(hist_slots=256)``, clean and with ``bug_stale_read``, a
2 s horizon) over seeds ``0..n-1`` in chunks, for the sizes
``chip_smoke.py`` phase 9 runs on the card and the small sizes its CPU
rehearsal runs. This test recomputes the small reports with
``madsim_tpu`` (the card-sized ones behind ``slow``), so the files cannot
go stale. Regenerate with
``JAX_PLATFORMS=cpu python tests/test_torch_checked_golden.py --write``.
"""

import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def reference_report(stale: bool, seeds: int, chunk: int) -> dict:
    from madsim_tpu.models import etcd
    from madsim_tpu.oracle.screen import checked_sweep

    cfg = etcd.EtcdConfig(**chip_smoke.etcd_fields(stale))
    ecfg = etcd.engine_config(cfg, time_limit_ns=chip_smoke.ETCD_HORIZON_NS)
    return checked_sweep(
        etcd.workload(cfg), ecfg, np.arange(seeds, dtype=np.int64),
        etcd.history_spec(), etcd.sweep_summary, chunk_size=chunk,
    )


def _golden(stale: bool) -> dict:
    with open(chip_smoke.golden_path(stale)) as f:
        return json.load(f)


@pytest.mark.parametrize("stale", [False, True], ids=["clean", "stale"])
def test_golden_config_is_what_chip_smoke_runs(stale):
    golden = _golden(stale)
    assert golden["config"] == chip_smoke.golden_config(stale)
    assert sorted(golden["reports"]) == sorted(
        chip_smoke.run_key(n, c) for n, c in chip_smoke.golden_runs(stale)
    )
    for report in golden["reports"].values():
        assert report["hist_undecided"] == 0 and report["budget_exceeded"] == 0
        if stale:
            assert report["hist_violations"] > 0 and report["violations"] == 0
        else:
            assert report["hist_violations"] == 0


@pytest.mark.parametrize("stale", [False, True], ids=["clean", "stale"])
def test_golden_rehearsal_report_is_the_reference(stale):
    seeds, chunk = chip_smoke.golden_runs(stale)[1]
    got = reference_report(stale, seeds, chunk)
    assert got == _golden(stale)["reports"][chip_smoke.run_key(seeds, chunk)]


@pytest.mark.slow
@pytest.mark.parametrize("stale", [False, True], ids=["clean", "stale"])
def test_golden_card_report_is_the_reference(stale):
    seeds, chunk = chip_smoke.golden_runs(stale)[0]
    got = reference_report(stale, seeds, chunk)
    assert got == _golden(stale)["reports"][chip_smoke.run_key(seeds, chunk)]


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_checked_golden.py --write")
    for stale in (False, True):
        reports = {
            chip_smoke.run_key(n, c): reference_report(stale, n, c)
            for n, c in chip_smoke.golden_runs(stale)
        }
        path = chip_smoke.golden_path(stale)
        with open(path, "w") as f:
            json.dump({"config": chip_smoke.golden_config(stale), "reports": reports}, f,
                      indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {path}")
