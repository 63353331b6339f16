"""The golden summaries and reports of ``chip_smoke.py`` phases 10-13.

Each file under ``madsim_tpu_torch/data/`` named in
``chip_smoke.GOLDEN_CONFIGS`` holds what the JAX package computes for a
phase's config, at the card's size and at the CPU rehearsal's:

- ``kafka_summary.json``: ``kafka.sweep_summary`` of ``KafkaConfig()`` at
  3 s over seeds ``0..n-1`` (phase 10);
- ``s3_summary.json`` and ``s3_bug_summary.json``: ``s3.sweep_summary``
  of ``S3Config()`` and of the ack-before-durable bug (phase 11);
- ``kafka_checked_clean.json`` and ``kafka_checked_bug.json``:
  ``checked_sweep`` reports of ``KafkaConfig(hist_slots=512)``, clean and
  with the ack-on-append bug (phase 12);
- ``etcd_stream.json``: the stream config's unchecked totals
  (``run_sweep_pipelined``) and checked report at the stream's chunk
  size (phase 13).

This test recomputes the rehearsal entries with ``madsim_tpu`` (the
card-sized ones behind ``slow``), so the files cannot go stale.
Regenerate with
``JAX_PLATFORMS=cpu python tests/test_torch_model_goldens.py --write``.
"""

import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _seeds(n):
    return np.arange(n, dtype=np.int64)


def _model(name):
    """The reference's model module and its config class."""
    from madsim_tpu.models import etcd, kafka, s3

    return {"kafka": (kafka, kafka.KafkaConfig), "s3": (s3, s3.S3Config),
            "etcd": (etcd, etcd.EtcdConfig)}[name]


def _ref_configs(golden: str):
    """The reference's (model module, config, engine config) of a golden."""
    from madsim_tpu.engine import faults

    conf = chip_smoke.GOLDEN_CONFIGS[golden]
    name = next(k for k in conf if k not in ("engine", "faults"))
    mod, cls = _model(name)
    fields = dict(conf[name])
    if "faults" in conf:
        fields["faults"] = faults.FaultSpec(**conf["faults"])
    cfg = cls(**fields)
    return mod, cfg, mod.engine_config(cfg, **conf["engine"])


def reference_summary(golden: str, n: int) -> dict:
    from madsim_tpu.engine import core

    mod, cfg, ecfg = _ref_configs(golden)
    return mod.sweep_summary(core.run_sweep(mod.workload(cfg), ecfg, _seeds(n)))


def reference_checked(golden: str, n: int, chunk: int) -> dict:
    import madsim_tpu.engine  # noqa: F401  (the reference's int64 mode, before its screens)
    from madsim_tpu.oracle.screen import checked_sweep

    mod, cfg, ecfg = _ref_configs(golden)
    return checked_sweep(mod.workload(cfg), ecfg, _seeds(n), mod.history_spec(),
                         mod.sweep_summary, chunk_size=chunk, workers=4)


def reference_totals(golden: str, n: int, chunk: int) -> dict:
    from madsim_tpu.engine.checkpoint import run_sweep_pipelined

    mod, cfg, ecfg = _ref_configs(golden)
    return run_sweep_pipelined(mod.workload(cfg), ecfg, _seeds(n), mod.sweep_summary,
                               chunk_size=chunk)


# golden file -> its runs, the card's then the rehearsal's
SUMMARIES = {
    "kafka_summary.json": chip_smoke.KAFKA_RUNS,
    "s3_summary.json": chip_smoke.S3_RUNS,
    "s3_bug_summary.json": chip_smoke.S3_BUG_RUNS,
}
CHECKED = {
    "kafka_checked_clean.json": chip_smoke.KAFKA_CLEAN_RUNS,
    "kafka_checked_bug.json": chip_smoke.KAFKA_BUG_RUNS,
}


def make(golden: str, card: bool) -> dict:
    """One golden file's entry at the card's size or the rehearsal's."""
    i = 0 if card else 1
    if golden in SUMMARIES:
        n = SUMMARIES[golden][i]
        return {"summaries": {f"seeds={n}": reference_summary(golden, n)}}
    if golden in CHECKED:
        n, chunk = CHECKED[golden][i]
        return {"reports": {chip_smoke.run_key(n, chunk): reference_checked(golden, n, chunk)}}
    n, chunk = chip_smoke.STREAM_RUNS[i]
    key = chip_smoke.run_key(n, chunk)
    return {"totals": {key: reference_totals(golden, n, chunk)},
            "checked": {key: reference_checked(golden, n, chunk)}}


def _keys(golden: str, card: bool) -> dict:
    """Entry kind -> the keys of the card's or the rehearsal's run."""
    i = 0 if card else 1
    if golden in SUMMARIES:
        return {"summaries": [f"seeds={SUMMARIES[golden][i]}"]}
    if golden in CHECKED:
        return {"reports": [chip_smoke.run_key(*CHECKED[golden][i])]}
    key = chip_smoke.run_key(*chip_smoke.STREAM_RUNS[i])
    return {"totals": [key], "checked": [key]}


def _entries(golden: str, card: bool) -> dict:
    """The stored entries of the card's or the rehearsal's run."""
    got = chip_smoke.load_golden(golden)
    return {kind: {key: got[kind][key] for key in keys}
            for kind, keys in _keys(golden, card).items()}


@pytest.mark.parametrize("golden", sorted(chip_smoke.GOLDEN_CONFIGS))
def test_golden_config_is_what_chip_smoke_runs(golden):
    got = chip_smoke.load_golden(golden)
    assert got["config"] == chip_smoke.GOLDEN_CONFIGS[golden]
    for card in (True, False):
        for kind, keys in _keys(golden, card).items():
            assert all(k in got[kind] for k in keys), (golden, kind, keys)
    for report in list(got.get("reports", {}).values()) + list(got.get("checked", {}).values()):
        assert report["hist_undecided"] == 0 and report["budget_exceeded"] == 0
    if golden == "kafka_checked_clean.json":
        assert all(r["hist_violations"] == 0 for r in got["reports"].values())
    if golden in ("s3_bug_summary.json",):
        assert all(s["violations"] > 0 for s in got["summaries"].values())


@pytest.mark.parametrize("golden", sorted(chip_smoke.GOLDEN_CONFIGS))
def test_golden_rehearsal_entry_is_the_reference(golden):
    assert make(golden, card=False) == _entries(golden, card=False)


@pytest.mark.slow
@pytest.mark.parametrize("golden", sorted(chip_smoke.GOLDEN_CONFIGS))
def test_golden_card_entry_is_the_reference(golden):
    assert make(golden, card=True) == _entries(golden, card=True)


if __name__ == "__main__":
    if sys.argv[1:2] != ["--write"]:
        sys.exit("usage: python tests/test_torch_model_goldens.py --write [golden ...]")
    for golden in sys.argv[2:] or sorted(chip_smoke.GOLDEN_CONFIGS):
        out = {"config": chip_smoke.GOLDEN_CONFIGS[golden]}
        for card in (True, False):
            for kind, entries in make(golden, card).items():
                out.setdefault(kind, {}).update(entries)
        path = chip_smoke.data_path(golden)
        with open(path, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {path}", flush=True)
