"""The correctness check fails what it must, at a size a CPU test holds.

Each case skips the harness's look for a card and drives the rest of a
run on the CPU (``run.run_cell(device="cpu")``): the control in the
program's place (the reference with a 32-bit clock) must come out not
correct, and so must a run with the timed path broken underneath: a step
that returns its state unchanged, a step that leaves half of the batch
out, and an answer altered where it is produced. (The cells run on one
chip: there is no exchange between chips to leave out.) The etcd cases
run a copy of the harness whose configuration stops a chunk after 400
steps (its seeds finish in under 200), so that a broken step cannot run
200,000 steps on the CPU. On a card (``gpu``) the etcd cell's report
faults are read again at the cell's own width, each reading printed.
"""

import json
import os
import shutil
import time

import pytest
import torch

from portbench import harness, run

LANES = 8


def _pkg(tmp_path, cell):
    if cell == "raft5.sweep":
        return harness.PKG
    dst = tmp_path / "portbench"
    shutil.copytree(harness.PKG, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    path = dst / "configs" / "etcd-lease-kv.json"
    cfg = json.loads(path.read_text())
    cfg["engine"]["max_steps"] = 400
    path.write_text(json.dumps(cfg))
    return str(dst)


def _run(pkg, cell, seconds, **kw):
    try:
        return run.run_cell(harness.load_benchmark(), cell, 2**31 + 11, seconds, False, "cpu",
                            lanes=LANES, pkg=pkg, t_start=time.perf_counter(), **kw)[0]
    finally:
        run.stop_helpers()


def _stuck(wl, cfg, state, device=None):
    return state


def _half(step):
    def half(wl, cfg, state, device=None):
        from madsim_tpu_torch.engine import tree

        new = step(wl, cfg, state, device=device)
        h = state.seed.shape[0] // 2
        return tree.map(lambda n, o: torch.cat([n[:h], o[h:]]), new, state)
    return half


def _altered(step):
    def altered(wl, cfg, state, device=None):
        new = step(wl, cfg, state, device=device)
        return new._replace(now_ns=new.now_ns + (~new.done).to(torch.int64))
    return altered


# the raft cell's control needs lanes past 2.147 s of virtual time, where
# a 32-bit nanosecond clock wraps: a whole chunk (about 600 steps)
@pytest.mark.parametrize("cell,seconds", [("raft5.sweep", 12.0), ("etcd.checked-clean", 0.5)])
def test_sound_run_correct_and_control_not(tmp_path, cell, seconds):
    line = _run(_pkg(tmp_path, cell), cell, seconds, with_control=True)
    assert line["correct"], line["compared"]
    assert not harness.within_limits(line["control"]), line["control"]
    assert line["control"]["lanes_mismatched"]["value"] > 0


@pytest.mark.parametrize("fault", ["stuck", "half", "altered"])
@pytest.mark.parametrize("cell", ["raft5.sweep", "etcd.checked-clean"])
def test_broken_step_is_not_correct(tmp_path, monkeypatch, cell, fault):
    from madsim_tpu_torch.engine import core

    step = core.step_batch
    broken = {"stuck": _stuck, "half": _half(step), "altered": _altered(step)}[fault]
    monkeypatch.setattr(core, "step_batch", broken)
    line = _run(_pkg(tmp_path, cell), cell, 0.5)
    assert not line["correct"], line["compared"]
    assert line["compared"]["lanes_mismatched"]["value"] > 0


def _short_report(monkeypatch):
    """Each chunk's report counts one lane fewer screened than it swept."""
    from madsim_tpu_torch.oracle import screen

    finalize = screen._HostWork._finalize

    def short(self, e):
        rep = finalize(self, e)
        return {**rep, "hist_screened": rep["hist_screened"] - 1}

    monkeypatch.setattr(screen._HostWork, "_finalize", short)


def _wrong_verdicts(monkeypatch):
    """A checker that calls every history non-linearizable, behind a
    screen that passes every lane to it: the report lists seeds the
    reference finds clean."""
    from madsim_tpu_torch.oracle import check, screen

    def all_suspect(final, spec, mesh=None, block=None):
        return torch.ones(final.seed.shape[0], dtype=torch.bool, device=final.seed.device)

    def all_bad(hists, spec, max_states=200_000, workers=0):
        return [check.CheckResult(ok=False, decided=True, bad_index=0, bad_op=None,
                                  reason="planted", states=0) for _ in hists]

    monkeypatch.setattr(screen, "screen_sweep", all_suspect)
    monkeypatch.setattr(check, "check_histories", all_bad)


# a planted fault of the etcd cell's report, and the number that catches it
REPORT_FAULTS = {"short_report": (_short_report, "lanes_unscreened"),
                 "wrong_verdicts": (_wrong_verdicts, "verdicts_mismatched")}


def test_report_that_skips_lanes_is_not_correct(tmp_path, monkeypatch):
    _short_report(monkeypatch)
    cell = "etcd.checked-clean"
    line = _run(_pkg(tmp_path, cell), cell, 0.5)
    assert not line["correct"]
    assert line["compared"]["lanes_unscreened"]["value"] > 0


def test_wrong_verdicts_are_not_correct(tmp_path, monkeypatch):
    _wrong_verdicts(monkeypatch)
    cell = "etcd.checked-clean"
    line = _run(_pkg(tmp_path, cell), cell, 0.5)
    assert not line["correct"]
    assert line["compared"]["verdicts_mismatched"]["value"] > 0
    assert line["compared"]["lanes_mismatched"]["value"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
@pytest.mark.parametrize("fault", sorted(REPORT_FAULTS))
def test_report_faults_at_the_cells_size(monkeypatch, fault, seed):
    """The same faults on the card, at the cell's own width (one chunk):
    each reading is printed for the record of the limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    plant, number = REPORT_FAULTS[fault]
    plant(monkeypatch)
    cell = "etcd.checked-clean"
    try:
        line = run.run_cell(harness.load_benchmark(), cell, seed, 1.0, False,
                            torch.device("cuda", 0), t_start=time.perf_counter())[0]
    finally:
        run.stop_helpers()
    print(json.dumps({"fault": fault, "seed": seed, "attempted": line["attempted"],
                      "compared": line["compared"]}))
    assert not line["correct"]
    assert line["compared"][number]["value"] > 0
