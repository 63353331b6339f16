"""The cases of ``tests/test_torch_scripts_*.py``: each runs one driver of
the repository's ``scripts/`` and its counterpart
``madsim_tpu_torch.scripts.<name>`` (``--device cpu``) with the same
arguments, and holds their exit codes, report files and stdout equal.

A record is what a run left: ``{"rc": int, "stdout": str, "files":
{name: text}}``, the run's directory written ``<d>`` in stdout.
``compare`` says how stdouts are held equal:

- ``exact``: every byte;
- ``json``: the last line as JSON, without the keys in ``TIME_KEYS`` (at
  any depth) and the case's ``ignore`` keys;
- ``numbers``: every number of every line, in order, the lines matching
  the case's ``skip`` pattern left out (where a line's wording names the
  package's own compilation, only its numbers are compared);
- ``lines``: the first ``n`` lines exactly;

and a case's ``mask`` pattern (an elapsed time) is taken out of every
line first.

The reference's records are the JAX package's, made once by
``JAX_PLATFORMS=cpu python tests/test_torch_scripts_golden.py --write``
into ``madsim_tpu_torch/data/scripts_golden.json``; ``-m slow`` remakes
the tier-1 cases' records and checks the file.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import re
import subprocess
import sys
from typing import Dict, List, NamedTuple, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "madsim_tpu_torch", "data", "scripts_golden.json")

# wall times and rates: the only fields of a JSON line that may differ
TIME_KEYS = {"wall_s", "seeds_per_sec", "events_per_sec", "sim_sec_per_wall_sec",
             "time_to_first_bug_s", "speedup"}
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


class Case(NamedTuple):
    name: str
    script: str  # scripts/<script>.py, and madsim_tpu_torch.scripts.<script>
    args: Tuple[str, ...]  # "{d}" is the run's directory
    files: Tuple[str, ...] = ()  # report files, relative to the directory
    compare: str = "exact"
    env: Tuple[Tuple[str, str], ...] = ()
    ignore: Tuple[str, ...] = ()  # json: keys left out besides TIME_KEYS
    skip: str = ""  # numbers: lines left out
    n: int = 0  # lines: how many
    mask: str = ""  # a pattern taken out of every line first (elapsed times)
    slow: bool = False


CASES = [
    Case("replay_volatile", "replay_seed", ("6", "--volatile")),
    Case("replay_etcd_history", "replay_seed",
         ("3", "--model", "etcd", "--history", "--stale-bug")),
    # the ragged tail: 16 + 8 padded to 16, the limit-masked summary
    Case("sweep_ragged", "sweep_million", ("24",), compare="json",
         env=(("MADSIM_SWEEP_CHUNK", "16"), ("MADSIM_HB_SECONDS", "0"))),
    Case("sweep_150", "sweep_million", ("150",), compare="json",
         env=(("MADSIM_SWEEP_CHUNK", "64"), ("MADSIM_HB_SECONDS", "0")), slow=True),
    Case("sweep_mesh", "sweep_million", ("32", "--mesh", "2"), compare="json",
         env=(("MADSIM_SWEEP_CHUNK", "16"), ("MADSIM_HB_SECONDS", "0")), slow=True),
    Case("checked_small", "checked_sweep_demo",
         ("--seeds", "32", "--chunk-size", "16", "--report", "{d}/r.json"), files=("r.json",)),
    Case("checked_gate", "checked_sweep_demo",
         ("--seeds", "96", "--chunk-size", "32", "--device-decode", "--report", "{d}/r.json"),
         files=("r.json",), slow=True),
    Case("oracle_demo", "oracle_demo", (), mask=r"^\[ *[0-9.]+s\] "),
    # the gate's explore leg: the tiny budget finds no violation (exit 1);
    # without the warm-up the reference counts its XLA compilations, the
    # port its kernel loads (none on the CPU)
    Case("explore_gate", "explore_demo",
         ("--rounds", "2", "--seeds-per-round", "64", "--campaign-seed", "0", "--no-shrink",
          "--report", "{d}/r.jsonl"), files=("r.jsonl",), compare="json",
         ignore=("compiles_in_campaign",)),
    Case("explore_smoke", "explore_demo",
         ("--rounds", "6", "--seeds-per-round", "128", "--campaign-seed", "5",
          "--assert-zero-recompile"), compare="json", slow=True),
    Case("differential_gate", "differential_demo",
         ("--seeds", "32", "--sim-seconds", "1.5", "--specs", "2", "--report", "{d}/r.json"),
         files=("r.json",)),
    Case("stream_smoke", "stream_smoke", (), compare="numbers", skip=r"^stream smoke: ALL OK"),
    Case("obs_smoke", "obs_smoke", ("{d}/obs",), compare="lines", n=3),
    Case("steer_pinned", "steer_demo",
         ("--policy", "bandit", "--budget", "8000", "--report", "{d}/r.jsonl",
          "--trace", "{d}/t.jsonl"), files=("r.jsonl", "t.jsonl")),
    Case("steer_gate", "steer_demo",
         ("--policy", "bandit", "--budget", "30000", "--report", "{d}/r.jsonl",
          "--trace", "{d}/t.jsonl"), files=("r.jsonl", "t.jsonl"), slow=True),
    Case("steer_drill", "steer_demo", ("--outdir", "{d}/out"), compare="json", slow=True),
    # one worker on the first unit of the plan, then the merged report
    Case("fleet_one_unit", "fleet_smoke",
         ("--worker", "--store", "{d}/store", "--name", "w", "--max-units", "1"),
         compare="json"),
    Case("fleet_merged_1", "fleet_smoke",
         ("--merged-only", "--workers", "1", "--report", "{d}/r.jsonl"), files=("r.jsonl",),
         slow=True),
    Case("fleet_drill", "fleet_smoke", ("--outdir", "{d}/out"), compare="json", slow=True),
    Case("multichip_smoke", "multichip_campaign", ("--smoke",), compare="json"),
    Case("wire_load", "wire_load_demo", ("--report", "{d}/r.json"), files=("r.json",)),
    Case("wire_fuzz", "wire_load_demo", ("--fuzz", "8", "--report", "{d}/r.json"),
         files=("r.json",)),
]
BY_NAME = {c.name: c for c in CASES}
# scripts that take no --device (host tier)
HOST_SCRIPTS = {"wire_load_demo"}


def _args(case: Case, d: str) -> List[str]:
    return [a.replace("{d}", d) for a in case.args]


def _collect(case: Case, d: str, rc: int, stdout: str) -> dict:
    files = {}
    for name in case.files:
        path = os.path.join(d, name)
        if os.path.exists(path):
            with open(path) as f:
                files[name] = f.read()
    return {"rc": rc, "stdout": stdout.replace(d, "<d>"), "files": files}


def run_reference(case: Case, d: str, timeout: float = 1800) -> dict:
    """The JAX package's script, in a fresh interpreter on JAX's CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **dict(case.env))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", case.script + ".py"), *_args(case, d)],
        cwd=d, env=env, capture_output=True, text=True, timeout=timeout,
    )
    return _collect(case, d, proc.returncode, proc.stdout)


def run_port(case: Case, d: str, monkeypatch) -> dict:
    """The port's driver in this process, on the CPU, with one torch
    thread (an eager step is hundreds of small ops)."""
    import torch

    for k, v in case.env:
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(d)
    args = _args(case, d)
    if case.script not in HOST_SCRIPTS:
        args += ["--device", "cpu"]
    mod = importlib.import_module(f"madsim_tpu_torch.scripts.{case.script}")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            try:
                rc = mod.main(args) or 0
            except SystemExit as e:
                rc = e.code if isinstance(e.code, int) else 1
    finally:
        torch.set_num_threads(threads)
    return _collect(case, d, rc, out.getvalue())


def _drop(obj, keys):
    if isinstance(obj, dict):
        return {k: _drop(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, list):
        return [_drop(v, keys) for v in obj]
    return obj


def comparable(case: Case, stdout: str):
    """What of a stdout is held equal (see the module docstring)."""
    if case.mask:
        stdout = re.sub(case.mask, "", stdout, flags=re.M)
    lines = stdout.splitlines()
    if case.compare == "exact":
        return stdout
    if case.compare == "json":
        return _drop(json.loads(lines[-1]), TIME_KEYS | set(case.ignore))
    if case.compare == "numbers":
        skip = re.compile(case.skip) if case.skip else None
        return [NUMBER.findall(ln) for ln in lines if not (skip and skip.search(ln))]
    if case.compare == "lines":
        return lines[: case.n]
    raise ValueError(case.compare)


def assert_same(case: Case, ref: dict, port: dict) -> None:
    assert port["rc"] == ref["rc"], (case.name, port, ref["rc"])
    assert comparable(case, port["stdout"]) == comparable(case, ref["stdout"]), case.name
    assert sorted(port["files"]) == sorted(ref["files"]) == sorted(case.files), case.name
    for name in case.files:
        assert port["files"][name] == ref["files"][name], (case.name, name)


def golden() -> Dict[str, dict]:
    with open(GOLDEN) as f:
        return json.load(f)


def check_case(name: str, tmp_path, monkeypatch, ref: Optional[dict] = None) -> dict:
    """The port's run of case ``name`` held to the reference's record
    (the golden's, unless given); returns the port's record."""
    case = BY_NAME[name]
    ref = golden()["cases"][name] if ref is None else ref
    d = str(tmp_path)
    port = run_port(case, d, monkeypatch)
    assert_same(case, ref, port)
    return port
