"""``madsim_tpu_torch.scripts.check_determinism`` and ``wire_load_demo``
on the CPU: the wire demo's report and fuzz digests against the JAX
package's ``scripts/wire_load_demo.py`` (``tests/_torch_scripts.py``);
the gate's cheapest leg (h: the wire demo and its fuzz, each in two fresh
processes) passing from the command line; the same leg with one byte of
one run's report changed failing, naming the leg and printing the
difference; and every driver of the device tier refusing to start
without a card unless given ``--device cpu``."""

import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

import _torch_scripts as ts

DEVICE_DRIVERS = [
    ("replay_seed", ["6"]), ("sweep_million", ["16"]), ("checked_sweep_demo", []),
    ("oracle_demo", []), ("explore_demo", []), ("differential_demo", []),
    ("stream_smoke", []), ("obs_smoke", []), ("steer_demo", []), ("fleet_smoke", []),
    ("multichip_campaign", ["--smoke"]), ("check_determinism", ["--legs", "h"]),
]


@pytest.mark.parametrize("name", ["wire_load", "wire_fuzz"])
def test_wire_load_demo_equals_the_reference(name, tmp_path, monkeypatch):
    ts.check_case(name, tmp_path, monkeypatch)


def test_the_cheapest_leg_passes_in_fresh_processes(tmp_path):
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "madsim_tpu_torch.scripts.check_determinism",
         "--legs", "h", "--out", str(out), "--device", "cpu"],
        cwd=ts.REPO, env=dict(os.environ, PYTHONPATH=ts.REPO), capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("determinism gate: OK [leg h] (wire load + fuzz")
    assert json.loads(lines[-1])["ok"] is True
    for a, b in (("wa.json", "wb.json"), ("wfa.json", "wfb.json")):
        assert (out / a).read_bytes() == (out / b).read_bytes() != b""


def test_a_planted_difference_fails_the_leg(tmp_path, capsys, monkeypatch):
    from madsim_tpu_torch.scripts import check_determinism as gate

    run_process = gate.run_process

    def planted(run, out):
        rc = run_process(run, out)
        if run.log == "wb.log":  # one byte of the second process's report
            path = os.path.join(out, "wb.json")
            blob = bytearray(open(path, "rb").read())
            i = blob.index(b'"frames": ') + len(b'"frames": ')
            blob[i] = ord("9") if blob[i] != ord("9") else ord("8")
            open(path, "wb").write(bytes(blob))
        return rc

    monkeypatch.setattr(gate, "run_process", planted)
    rc, seconds = gate.gate([gate.legs("cpu")["h"]], str(tmp_path))
    err = capsys.readouterr().err
    assert rc == 1 and list(seconds) == ["h"]
    assert "determinism gate: FAILED [leg h] — wire load/fuzz reports differ" in err
    assert any(ln.startswith("-") and '"frames"' in ln for ln in err.splitlines())
    assert any(ln.startswith("+") and '"frames"' in ln for ln in err.splitlines())


@pytest.mark.parametrize("name,args", DEVICE_DRIVERS, ids=[n for n, _ in DEVICE_DRIVERS])
def test_device_drivers_refuse_to_start_without_a_card(name, args, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device legitimately runs there")
    mod = importlib.import_module(f"madsim_tpu_torch.scripts.{name}")
    with pytest.raises(SystemExit) as e:
        mod.main(args)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert err.startswith(f"{name}: ") and "no GPU is available" in err


@pytest.mark.slow
def test_the_whole_gate_on_the_cpu(tmp_path):
    """All twelve legs (a)-(l), each in fresh processes on the CPU (one
    torch thread each), as ``scripts/check_determinism.sh`` runs them;
    the seconds of each leg are in the last line."""
    proc = subprocess.run(
        [sys.executable, "-m", "madsim_tpu_torch.scripts.check_determinism",
         "--device", "cpu", "--out", str(tmp_path / "out")],
        cwd=ts.REPO, env=dict(os.environ, PYTHONPATH=ts.REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=7200)
    print(proc.stdout)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-20000:]
    last = json.loads(proc.stdout.splitlines()[-1])
    assert last["ok"] and list(last["legs"]) == list("abcdefghijkl")
