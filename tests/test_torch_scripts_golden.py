"""The JAX package's records of its ``scripts/`` drivers, which the
port's drivers (``madsim_tpu_torch.scripts``) are held to.

``madsim_tpu_torch/data/scripts_golden.json`` holds:

- ``cases``: one record per tier-1 case of ``tests/_torch_scripts.py``
  (exit code, stdout, report files), each the reference script's run at
  the case's arguments on JAX's CPU;
- ``dump``: the determinism gate's dump (``scripts/check_determinism.sh``'s
  first heredoc, run as it is): the name, dtype, shape and sha256 of every
  array, and the sha256 of the whole ``.npz``;
- ``sweep_million``: ``scripts/sweep_million.py TOTAL CKPT_DIR`` at
  ``chip_smoke.SCRIPT_SWEEP_RUNS`` (the card's 17,384 seeds in chunks of
  16,384, and the rehearsal's): its JSON line and every chunk file's
  summary — what ``chip_smoke.py`` phase 21 (a) holds the port to.

Regenerate with
``JAX_PLATFORMS=cpu python tests/test_torch_scripts_golden.py --write``
(the card-sized sweep takes the longest). ``-m slow``
remakes the tier-1 cases, the dump and the rehearsal-sized sweep with the
JAX package and checks them against the file, and runs the slow cases of
``_torch_scripts`` live through both packages.
"""

import glob
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_scripts as ts  # noqa: E402
import chip_smoke  # noqa: E402


def reference_dump_source() -> str:
    """The dump's Python, verbatim from ``scripts/check_determinism.sh``."""
    with open(os.path.join(REPO, "scripts", "check_determinism.sh")) as f:
        text = f.read()
    lo = text.index("<<'EOF'\n") + len("<<'EOF'\n")
    return text[lo:text.index("\nEOF\n", lo)] + "\n"


def npz_record(path: str) -> dict:
    """Every array's dtype, shape and sha256, and the file's sha256."""
    import numpy as np

    arrays = {}
    with np.load(path) as z:
        for k in z.files:
            a = z[k]
            arrays[k] = [str(a.dtype), list(a.shape),
                         hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()]
    with open(path, "rb") as f:
        return {"arrays": arrays, "sha256": hashlib.sha256(f.read()).hexdigest()}


def reference_dump() -> dict:
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "dump.py")
        with open(src, "w") as f:
            f.write(reference_dump_source())
        path = os.path.join(d, "a.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
        subprocess.run([sys.executable, src, path], cwd=REPO, env=env, check=True,
                       capture_output=True, timeout=1800)
        return npz_record(path)


def chunk_summaries(ckpt_dir: str) -> dict:
    out = {}
    for path in sorted(glob.glob(os.path.join(ckpt_dir, "chunk_*.json"))):
        with open(path) as f:
            out[os.path.basename(path)] = json.load(f)["summary"]
    return out


def reference_sweep(total: int, chunk: int) -> dict:
    """``scripts/sweep_million.py TOTAL CKPT_DIR`` at chunk ``chunk``."""
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "ck")
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                   MADSIM_SWEEP_CHUNK=str(chunk), MADSIM_HB_SECONDS="0")
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", "sweep_million.py"), str(total), ck],
            cwd=d, env=env, capture_output=True, text=True, check=True, timeout=3600)
        return {"line": json.loads(proc.stdout.splitlines()[-1]),
                "chunks": chunk_summaries(ck)}


def sweep_key(total: int, chunk: int) -> str:
    return f"{total}/{chunk}"


def _case(case) -> dict:
    with tempfile.TemporaryDirectory() as d:
        rec = ts.run_reference(case, d)
    print(f"  {case.name}: rc {rec['rc']}", flush=True)
    return rec


def make(names=None, card: bool = True) -> dict:
    """The records; with ``names``, those cases' alone."""
    from concurrent.futures import ThreadPoolExecutor

    cases = [c for c in ts.CASES if not c.slow and (not names or c.name in names)]
    with ThreadPoolExecutor(3) as pool:  # each reference run is a process of its own
        out = {"cases": dict(zip([c.name for c in cases], pool.map(_case, cases)))}
    if names:
        return out
    out["dump"] = reference_dump()
    out["sweep_million"] = {}
    for total, chunk in chip_smoke.SCRIPT_SWEEP_RUNS[0 if card else 1:]:
        out["sweep_million"][sweep_key(total, chunk)] = reference_sweep(total, chunk)
    return out


@pytest.mark.slow
def test_the_golden_is_the_reference():
    """The tier-1 records, the dump and the rehearsal's sweep, remade
    with the JAX package, equal the file's."""
    want = ts.golden()
    got = make(card=False)
    for name, rec in got["cases"].items():
        ts.assert_same(ts.BY_NAME[name], rec, want["cases"][name])
    assert got["dump"] == want["dump"]
    for key, rec in got["sweep_million"].items():
        assert rec["chunks"] == want["sweep_million"][key]["chunks"]
        assert ts.comparable(ts.Case("", "", (), compare="json"), json.dumps(rec["line"])) == \
            ts.comparable(ts.Case("", "", (), compare="json"),
                          json.dumps(want["sweep_million"][key]["line"]))


@pytest.mark.slow
@pytest.mark.parametrize("name", [c.name for c in ts.CASES if c.slow])
def test_the_slow_cases_live(name, tmp_path, monkeypatch):
    """The heavier cases (the Makefile's sizes and the full drills): the
    reference script and the port's driver, both live."""
    case = ts.BY_NAME[name]
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    ref = ts.run_reference(case, str(ref_dir))
    port_dir = tmp_path / "port"
    port_dir.mkdir()
    ts.check_case(name, port_dir, monkeypatch, ref=ref)


if __name__ == "__main__":
    if sys.argv[1:2] != ["--write"]:
        sys.exit("usage: python tests/test_torch_scripts_golden.py --write [case ...]")
    names = sys.argv[2:]
    got = make(names)
    if names:
        old = ts.golden()
        old["cases"].update(got["cases"])
        got = old
    with open(ts.GOLDEN, "w") as f:
        json.dump(got, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {ts.GOLDEN}", flush=True)
