"""The golden files ``chip_smoke.py`` phase 16 checks the port against on
the card, each made by the JAX reference on the CPU:

- ``steer_raft.json``: ``explore.run_steered``'s JSONL report and
  decision trace (text and sha256) and fingerprints of the raft steer
  gate at each ``chip_smoke.STEER_RUNS`` size;
- ``fleet_drill.json``: ``explore.merged_report`` after one
  ``run_worker`` over the fleet drill's units at each
  ``chip_smoke.FLEET_RUNS`` size, and ``data/fleet_store/`` the store
  that the card-sized run wrote (phase 16's regression gate replays it);
- ``differential_device.json``: ``run_differential``'s report (text) at
  each ``chip_smoke.DIFF_RUNS`` size and ``device_outcomes_grid``'s
  ``TierOutcome``s at each ``chip_smoke.DIFF_GRID_RUNS`` size;
- ``differential_host.json``: the host tier's ``TierOutcome`` of every
  ``DIFF_RUNS`` grid, keyed by ``differential.host_key`` — the golden
  that the port's ``host_outcomes``, run live on the port's host
  runtime, is held to.

The rehearsal-sized entries are recomputed with ``madsim_tpu`` in
tier-1 by the parity tests whose reference runs are those configs
(``tests/test_torch_steer.py``, ``test_torch_orchestrator.py`` and
``test_torch_differential.py``), and the card-sized ones here behind
``slow``, so the files cannot go stale.
Regenerate with ``JAX_PLATFORMS=cpu python tests/test_torch_explore_golden.py
--write [steer] [fleet] [differential]`` (all three when none is named;
the card-sized steered campaign takes the longest).
"""

import hashlib
import json
import os
import shutil
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from madsim_tpu_torch.explore import differential as pdiff  # noqa: E402


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def reference_steer(run) -> dict:
    """The reference's steered campaign of the raft steer gate."""
    import madsim_tpu.engine  # noqa: F401  (the reference's int64 mode)
    from madsim_tpu import explore

    target, base = explore.steer_gate(smoke=True)
    ccfg, scfg = chip_smoke.steer_configs(explore, run)
    with tempfile.TemporaryDirectory() as tmp:
        rp, tp = os.path.join(tmp, "report.jsonl"), os.path.join(tmp, "trace.jsonl")
        res = explore.run_steered(target, base, ccfg, scfg, report_path=rp, trace_path=tp)
        with open(rp) as f:
            report = f.read()
        with open(tp) as f:
            trace = f.read()
    kinds = [d["kind"] for d in res.decisions]
    return {"report": report, "trace": trace, "report_sha256": _sha(report),
            "trace_sha256": _sha(trace), "fingerprints": list(res.fingerprints),
            "decisions": kinds.count("decide"), "kills": kinds.count("kill"),
            "escalations": kinds.count("escalate"), "spent_events": res.spent_events}


def reference_fleet(run, root: str) -> str:
    """The reference's merged report after one worker ran the drill's
    units into a fresh store at ``root``."""
    import madsim_tpu.engine  # noqa: F401
    from madsim_tpu import explore
    from madsim_tpu.engine.faults import FaultSpec

    target, base, ccfg = chip_smoke.fleet_setup(explore, FaultSpec, run)
    explore.run_worker(target, base, ccfg, explore.CorpusStore(root, worker="solo"),
                       chip_smoke.FLEET_UNITS, shrink_tests=run[2])
    return explore.merged_report(explore.CorpusStore(root, worker="report"))


def reference_differential(run) -> dict:
    """The reference's ``run_differential`` over ``gate_specs()``: its
    report text and, keyed for the port, its host outcomes."""
    import madsim_tpu.engine  # noqa: F401
    from madsim_tpu import explore
    from madsim_tpu_torch import explore as pexplore

    from _torch_parity import port_spec

    dcfg = chip_smoke.diff_config(explore, run)
    report = explore.run_differential(explore.gate_specs(), dcfg)
    pcfg = chip_smoke.diff_config(pexplore, run)
    host = {pdiff.host_key(port_spec(spec), pcfg): rec["host"]
            for spec, rec in zip(explore.gate_specs(), report["specs"])}
    return {"report": json.dumps(report, sort_keys=True) + "\n", "host": host}


def reference_grid(run) -> list:
    import madsim_tpu.engine  # noqa: F401
    from madsim_tpu import explore
    from madsim_tpu.explore import differential

    return [o._asdict() for o in differential.device_outcomes_grid(
        explore.gate_specs(), chip_smoke.diff_config(explore, run))]


def _golden(name: str) -> dict:
    return chip_smoke.load_golden(name)


def test_goldens_hold_what_chip_smoke_runs():
    steer = _golden(chip_smoke.STEER_GOLDEN)
    assert sorted(steer["runs"]) == sorted(chip_smoke.steer_key(r) for r in chip_smoke.STEER_RUNS)
    for rec in steer["runs"].values():
        assert _sha(rec["report"]) == rec["report_sha256"]
        assert _sha(rec["trace"]) == rec["trace_sha256"]
        assert rec["fingerprints"] and rec["escalations"] >= 1
    fleet = _golden(chip_smoke.FLEET_GOLDEN)
    assert fleet["units"] == chip_smoke.FLEET_UNITS
    assert sorted(fleet["runs"]) == sorted(chip_smoke.fleet_key(r) for r in chip_smoke.FLEET_RUNS)
    for rec in fleet["runs"].values():
        assert rec["report"].count('"kind": "cand"') == 2 * chip_smoke.FLEET_UNITS
    store = chip_smoke.data_path(chip_smoke.FLEET_STORE)
    with open(os.path.join(store, "log", "solo.jsonl")) as f:
        assert any(json.loads(line)["kind"] == "bug" for line in f)
    diff = _golden(chip_smoke.DIFF_GOLDEN)
    assert sorted(diff["reports"]) == sorted(chip_smoke.diff_key(r) for r in chip_smoke.DIFF_RUNS)
    assert sorted(diff["grids"]) == sorted(chip_smoke.diff_key(r)
                                           for r in chip_smoke.DIFF_GRID_RUNS)
    from madsim_tpu_torch import explore as pexplore

    specs = pdiff.gate_specs()
    host = _golden(chip_smoke.DIFF_HOST_GOLDEN)["host"]
    for run in chip_smoke.DIFF_RUNS:
        dcfg = chip_smoke.diff_config(pexplore, run)
        report = json.loads(diff["reports"][chip_smoke.diff_key(run)])
        hosts = [host[pdiff.host_key(spec, dcfg)] for spec in specs]
        assert hosts == [rec["host"] for rec in report["specs"]]


@pytest.mark.slow
def test_golden_card_steer_is_the_reference():
    run = chip_smoke.STEER_RUNS[0]
    assert reference_steer(run) == _golden(chip_smoke.STEER_GOLDEN)["runs"][
        chip_smoke.steer_key(run)]


@pytest.mark.slow
def test_golden_card_fleet_and_store_are_the_reference(tmp_path):
    from madsim_tpu import explore

    run = chip_smoke.FLEET_RUNS[0]
    root = str(tmp_path / "store")
    assert reference_fleet(run, root) == _golden(
        chip_smoke.FLEET_GOLDEN)["runs"][chip_smoke.fleet_key(run)]["report"]
    kept = str(tmp_path / "kept")
    shutil.copytree(chip_smoke.data_path(chip_smoke.FLEET_STORE), kept)
    assert explore.CorpusStore(kept, worker="r").merged() == \
        explore.CorpusStore(root, worker="r").merged()


@pytest.mark.slow
def test_golden_card_differential_is_the_reference():
    run, grid = chip_smoke.DIFF_RUNS[0], chip_smoke.DIFF_GRID_RUNS[0]
    golden = _golden(chip_smoke.DIFF_GOLDEN)
    assert reference_differential(run)["report"] == golden["reports"][chip_smoke.diff_key(run)]
    assert reference_grid(grid) == golden["grids"][chip_smoke.diff_key(grid)]


def _update(name: str, fn) -> None:
    path = chip_smoke.data_path(name)
    data = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    fn(data)
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {path}")


def _write_steer(data: dict) -> None:
    data["config"] = {"target": "explore.steer_gate(smoke=True)",
                      "families": list(chip_smoke.STEER_FAMILIES),
                      "escalate_seeds": chip_smoke.STEER_ESCALATE_SEEDS,
                      "kill_plays": chip_smoke.STEER_KILL_PLAYS,
                      "campaign_seed": chip_smoke.STEER_CAMPAIGN_SEED}
    data["runs"] = {chip_smoke.steer_key(r): reference_steer(r) for r in chip_smoke.STEER_RUNS}


def _write_fleet(data: dict) -> None:
    data["config"] = {"target": chip_smoke.FLEET_TARGET, "base": chip_smoke.FLEET_BASE,
                      "campaign": chip_smoke.FLEET_CAMPAIGN}
    data["units"] = chip_smoke.FLEET_UNITS
    data["runs"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, run in enumerate(chip_smoke.FLEET_RUNS):
            root = os.path.join(tmp, f"store{i}")
            data["runs"][chip_smoke.fleet_key(run)] = {"report": reference_fleet(run, root)}
            if i == 0:
                keep = chip_smoke.data_path(chip_smoke.FLEET_STORE)
                shutil.rmtree(keep, ignore_errors=True)
                os.makedirs(os.path.join(keep, "log"))
                shutil.copy(os.path.join(root, "log", "solo.jsonl"),
                            os.path.join(keep, "log", "solo.jsonl"))


def _write_differential(data: dict) -> None:
    host: dict = {}
    data["reports"] = {}
    for run in chip_smoke.DIFF_RUNS:
        out = reference_differential(run)
        data["reports"][chip_smoke.diff_key(run)] = out["report"]
        host.update(out["host"])
    data["grids"] = {chip_smoke.diff_key(r): reference_grid(r) for r in chip_smoke.DIFF_GRID_RUNS}
    _update("differential_host.json", lambda d: d.update(host=host))


if __name__ == "__main__":
    parts = {"steer": (chip_smoke.STEER_GOLDEN, _write_steer),
             "fleet": (chip_smoke.FLEET_GOLDEN, _write_fleet),
             "differential": (chip_smoke.DIFF_GOLDEN, _write_differential)}
    if sys.argv[1:2] != ["--write"] or not set(sys.argv[2:]) <= set(parts):
        sys.exit("usage: python tests/test_torch_explore_golden.py --write "
                 "[steer] [fleet] [differential]")
    for part in sys.argv[2:] or list(parts):
        _update(*parts[part])
