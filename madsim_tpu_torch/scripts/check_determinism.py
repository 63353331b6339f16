"""The determinism gate (counterpart of ``scripts/check_determinism.sh``):
each leg runs the same work in two (or more) separate processes — fresh
process state, fresh kernel loads — and compares their outputs as bytes.
Any drift in the schedule derivation, the engine loop, the fault
interpreter, the checker, the drivers or the wires fails the gate.

Usage, from the repository root:
    python -m madsim_tpu_torch.scripts.check_determinism [--legs abcdefghijkl] [--device D]
        [--out DIR] [--jobs N]

``--legs`` takes letters (``--legs ac``) or names (``--legs dump,mesh``).
The legs (the reference's, in its order), by letter and name:

  a  dump: a 256-seed sweep of ``RaftConfig(num_nodes=4, commands=4,
     faults=FaultSpec(crashes=2, partitions=2, spikes=1, losses=1,
     pauses=1))`` (3 s, 30,000 steps) keeping every state leaf, the
     ``run_traced`` traces of seeds 0 and 7, and the etcd histories of
     seeds 0, 5 and 11 (each asserted equal between the sweep lane and
     the traced replay), saved as ``.npz`` with the reference's array
     names, dtypes and shapes; the two archives must be equal as bytes
  b  explore: two campaign runs of one campaign seed, equal JSONL reports
  c  workers: the checked sweep x workers {0, 2}, in two processes each
  d  mesh: the checked sweep x mesh {1, 2}, equal to c's unsharded report
  e  stream: the stream driver, equal to c's report
  f  decode: device decode, equal to c's report
  g  telemetry: on and off for the checked sweep (stream driver) and the
     campaign, equal to c's and b's reports, journal and trace written
  h  wire: ``wire_load_demo`` and its ``--fuzz 8``
  i  serving: ``wire_load --determinism`` x {async, legacy} x telemetry
  j  differential: the differential, equal reports
  k  fleet: the fleet's merged report x workers {1, 2}
  l  steer: the steered campaign's report and decision trace x telemetry

``--device`` (default CUDA) goes to the drivers of the device tier (every
leg but h and i, which run on the CPU by design); without a card and
without ``--device cpu`` the gate exits 2 before any leg runs. A leg that
compares against another leg's output (d-g) first makes that output, in
one process, when it is not there yet, so ``--legs`` may pick any subset.

Prints one line per leg and, last, one JSON line with each leg's seconds.
Exits 1 on the first difference, naming the leg and printing a diff.
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

from . import _cli

# the repository root, on every run's PYTHONPATH for ``python -m``
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ALL_LEGS = "abcdefghijkl"
# each leg's name, for --legs
LEG_NAMES = dict(zip(
    ("dump", "explore", "workers", "mesh", "stream", "decode", "telemetry", "wire",
     "serving", "differential", "fleet", "steer"), ALL_LEGS))
RUN_TIMEOUT_S = 3600

# the dump's configuration (check_determinism.sh:46-54)
DUMP_SEEDS = 256
DUMP_TRACED = (0, 7)
DUMP_HIST_SWEEP = 16
DUMP_HIST_SEEDS = (0, 5, 11)


def dump(path: str, device) -> dict:
    """Leg (a)'s dump, written to ``path`` (``np.savez``); returns the
    engine steps it ran and pop-min's launches over them (equal on a
    card: one launch per step), as ``core.StepCount`` counts them."""
    import numpy as np

    from ..engine import core
    from ..engine.faults import FaultSpec
    from ..engine.state_io import to_numpy_leaves
    from ..explore.targets import oracle_demo_faults, stale_etcd_target
    from ..models import raft
    from ..oracle import decode_seed, history_bytes

    spec = FaultSpec(
        crashes=2, crash_window_ns=1_500_000_000,
        partitions=2, part_window_ns=1_500_000_000,
        spikes=1, losses=1, pauses=1,
    )
    cfg = raft.RaftConfig(num_nodes=4, commands=4, faults=spec)
    ecfg = raft.engine_config(cfg, time_limit_ns=3_000_000_000, max_steps=30_000)
    wl = raft.workload(cfg)

    with core.StepCount() as count:
        blobs = {}
        # a small sweep: every per-seed counter and latched flag
        final = core.run_sweep(wl, ecfg, np.arange(DUMP_SEEDS, dtype=np.int64), device=device)
        for i, leaf in enumerate(to_numpy_leaves(final)):
            blobs[f"sweep.{i}"] = leaf
        del final
        # two traced replays: the full dispatched event schedule
        for seed in DUMP_TRACED:
            _, trace = core.run_traced(wl, ecfg, seed, device=device)
            for k in sorted(trace):
                blobs[f"trace{seed}.{k}"] = trace[k].cpu().numpy()

        # histories of the oracle pipeline's clean etcd control: the
        # sweep lane's canonical bytes, equal to the traced replay's
        wl2, ecfg2 = stale_etcd_target(bug_stale_read=False).build(oracle_demo_faults())
        hfinal = core.run_sweep(
            wl2, ecfg2, np.arange(DUMP_HIST_SWEEP, dtype=np.int64), device=device)
        for seed in DUMP_HIST_SEEDS:
            sweep_b = history_bytes(decode_seed(hfinal, seed))
            tfinal, _ = core.run_traced(wl2, ecfg2, seed, device=device)
            if history_bytes(decode_seed(tfinal)) != sweep_b:
                raise AssertionError(
                    f"history path divergence at seed {seed}: sweep lane != traced replay")
            blobs[f"hist{seed}"] = np.frombuffer(sweep_b, dtype=np.uint8)

    np.savez(path, **blobs)
    print(f"wrote {len(blobs)} arrays -> {path}")
    return {"arrays": len(blobs), "engine_steps": count.steps,
            "pop_min_launches": count.launches, "device": str(device)}


def _dump_main(path: str, device) -> int:
    out = dump(path, device)
    print(json.dumps({"dump": out}, sort_keys=True), file=sys.stderr)
    if device.type == "cuda" and out["pop_min_launches"] != out["engine_steps"]:
        print(f"dump: pop_min launches ({out['pop_min_launches']}) != engine steps "
              f"({out['engine_steps']})", file=sys.stderr)
        return 1
    return 0


# ---------------------------------------------------------------------------
# legs


class Run(NamedTuple):
    """One fresh process: ``python -m module *args`` from the repository
    root, its stdout and stderr to ``log`` in the output directory.
    ``may_fail``: its exit code is not checked (the reference's
    ``|| true``: only its output files decide)."""

    log: str
    module: str
    args: Tuple[str, ...]
    may_fail: bool = False


class Leg(NamedTuple):
    """``runs`` in order (after ``needs``: runs whose first output is
    missing), then every group of ``same`` must hold files equal as
    bytes and every file of ``nonempty`` must exist and not be empty."""

    name: str
    ok: str  # what an OK line says
    failed: str  # what a FAILED line says
    runs: Tuple[Run, ...]
    same: Tuple[Tuple[str, ...], ...]
    nonempty: Tuple[str, ...] = ()
    needs: Tuple[Tuple[str, Run], ...] = ()
    # files whose differences are described rather than diffed
    describe: Optional[Callable[[str, str], List[str]]] = None


def _m(name: str) -> str:
    return f"madsim_tpu_torch.scripts.{name}"


def _npz_differences(a: str, b: str) -> List[str]:
    import numpy as np

    out = []
    with np.load(a) as x, np.load(b) as y:
        for k in sorted(set(x.files) | set(y.files)):
            if k not in x.files or k not in y.files:
                out.append(f"  {k}: only in one run")
            elif not (x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])):
                out.append(f"  {k}: differs")
    return out


def legs(device: str) -> dict:
    """The reference's legs, keyed by letter; ``device`` goes to the
    device-tier drivers."""
    d = ("--device", device)
    cs = ("--seeds", "96", "--chunk-size", "32")
    ex = ("--rounds", "2", "--seeds-per-round", "64", "--campaign-seed", "0", "--no-shrink")

    def checked(tag: str, *extra: str) -> Run:
        return Run(f"cs_{tag}.log", _m("checked_sweep_demo"),
                   (*cs, *extra, "--report", f"cs_{tag}.json", *d))

    def explore(r: str, *extra: str) -> Run:
        # the tiny budget finds no violation: exit 1 is expected, and only
        # a missing report means the campaign crashed
        return Run(f"{r}.log", _m("explore_demo"),
                   (*ex, *extra, "--report", f"{r}.jsonl", *d), True)

    base_cs = ("cs_a_w0.json", checked("a_w0", "--workers", "0"))
    base_ex = ("a.jsonl", explore("a"))
    out = {}
    out["a"] = Leg(
        "a", "two processes, byte-identical traces + histories",
        "traces differ between identical runs",
        tuple(Run(f"{r}.dump.log", _m("check_determinism"), ("--dump", f"{r}.npz", *d))
              for r in "ab"),
        (("a.npz", "b.npz"),), ("a.npz",), describe=_npz_differences)
    out["b"] = Leg(
        "b", "two campaign runs, byte-identical reports",
        "campaign reports differ or are empty",
        (explore("a"), explore("b")), (("a.jsonl", "b.jsonl"),), ("a.jsonl",))
    out["c"] = Leg(
        "c", "checked sweep, 2 processes x 2 pool sizes, byte-identical",
        "checked-sweep reports differ or are empty",
        tuple(checked(f"{r}_w{w}", "--workers", w) for w in "02" for r in "ab"),
        (("cs_a_w0.json", "cs_b_w0.json", "cs_a_w2.json", "cs_b_w2.json"),),
        ("cs_a_w0.json",))
    out["d"] = Leg(
        "d", "sharded checked sweep, 2 processes x 2 mesh sizes == unsharded, "
        "byte-identical",
        "sharded checked-sweep reports differ from unsharded or are empty",
        tuple(checked(f"{r}_m{m}", "--workers", "0", "--mesh", m) for m in "12" for r in "ab"),
        (("cs_a_w0.json", "cs_a_m1.json", "cs_b_m1.json", "cs_a_m2.json", "cs_b_m2.json"),),
        ("cs_a_m1.json",), (base_cs,))
    out["e"] = Leg(
        "e", "streaming checked sweep, 2 processes x 2 drivers, byte-identical",
        "streaming checked-sweep reports differ from chunked or are empty",
        tuple(checked(f"{r}_stream", "--workers", "0", "--driver", "stream") for r in "ab"),
        (("cs_a_w0.json", "cs_a_stream.json", "cs_b_stream.json"),),
        ("cs_a_stream.json",), (base_cs,))
    out["f"] = Leg(
        "f", "device-decode checked sweep, 2 processes x 2 decode paths, byte-identical",
        "device-decode checked-sweep reports differ from host-decode or are empty",
        tuple(checked(f"{r}_dd", "--workers", "0", "--device-decode") for r in "ab"),
        (("cs_a_w0.json", "cs_a_dd.json", "cs_b_dd.json"),), ("cs_a_dd.json",), (base_cs,))
    out["g"] = Leg(
        "g", "telemetry on/off x 2 processes, byte-identical reports",
        "telemetry changed report bytes (or wrote no journal/trace)",
        tuple(run for r in "ab" for run in (
            checked(f"{r}_telem", "--workers", "0", "--driver", "stream",
                    "--telemetry-dir", f"obs_cs_{r}"),
            explore(f"{r}_telem", "--telemetry-dir", f"obs_ex_{r}"))),
        (("cs_a_w0.json", "cs_a_telem.json", "cs_b_telem.json"),
         ("a.jsonl", "a_telem.jsonl", "b_telem.jsonl")),
        ("cs_a_telem.json", "a_telem.jsonl", "obs_cs_a/journal.jsonl", "obs_cs_a/trace.json"),
        (base_cs, base_ex))
    out["h"] = Leg(
        "h", "wire load + fuzz, 2 processes x 2 paths, byte-identical",
        "wire load/fuzz reports differ or are empty",
        tuple(Run(f"{r}.log", _m("wire_load_demo"), ("--report", f"{r}.json"), True)
              for r in ("wa", "wb"))
        + tuple(Run(f"{r}.log", _m("wire_load_demo"), ("--fuzz", "8", "--report", f"{r}.json"),
                    True) for r in ("wfa", "wfb")),
        (("wa.json", "wb.json"), ("wfa.json", "wfb.json")), ("wa.json", "wfa.json"))
    out["i"] = Leg(
        "i", "serving core, 2 processes x 2 servers x telemetry on/off, byte-identical",
        "serving-core wire reports differ or are empty",
        tuple(Run(f"{r}.log", "madsim_tpu_torch.wire_load",
                  ("--determinism", *extra, "--report", f"{r}.json"), True)
              for r, extra in (("sa", ("--server", "async")), ("sb", ("--server", "async")),
                               ("sl", ("--server", "legacy")),
                               ("st", ("--server", "async", "--telemetry")))),
        (("sa.json", "sb.json", "sl.json", "st.json"),), ("sa.json",))
    out["j"] = Leg(
        "j", "two differential runs, byte-identical reports",
        "differential reports differ or are empty",
        tuple(Run(f"{r}.log", _m("differential_demo"),
                  ("--seeds", "32", "--sim-seconds", "1.5", "--specs", "2",
                   "--report", f"{r}.json", *d), True) for r in ("da", "db")),
        (("da.json", "db.json"),), ("da.json",))
    out["k"] = Leg(
        "k", "fleet merged corpus, 2 processes x 2 worker counts, byte-identical",
        "fleet merged reports differ or are empty",
        tuple(Run(f"fleet_{r}_w{w}.log", _m("fleet_smoke"),
                  ("--merged-only", "--workers", w, "--report", f"fleet_{r}_w{w}.jsonl", *d))
              for w in "12" for r in "ab"),
        (("fleet_a_w1.jsonl", "fleet_b_w1.jsonl", "fleet_a_w2.jsonl", "fleet_b_w2.jsonl"),),
        ("fleet_a_w1.jsonl",))
    steer = ("--policy", "bandit", "--budget", "30000")
    out["l"] = Leg(
        "l", "steered campaign, 2 processes x telemetry on/off, byte-identical report + "
        "decision trace",
        "steered campaign report/trace differ or are empty",
        tuple(run for r in "ab" for run in (
            Run(f"steer_{r}.log", _m("steer_demo"),
                (*steer, "--report", f"steer_{r}.jsonl", "--trace", f"steer_{r}.trace.jsonl",
                 *d)),
            Run(f"steer_{r}_telem.log", _m("steer_demo"),
                (*steer, "--telemetry-dir", f"obs_steer_{r}",
                 "--report", f"steer_{r}_telem.jsonl",
                 "--trace", f"steer_{r}_telem.trace.jsonl", *d)))),
        (("steer_a.jsonl", "steer_b.jsonl", "steer_a_telem.jsonl", "steer_b_telem.jsonl"),
         ("steer_a.trace.jsonl", "steer_b.trace.jsonl", "steer_a_telem.trace.jsonl",
          "steer_b_telem.trace.jsonl")),
        ("steer_a.jsonl", "steer_a.trace.jsonl", "obs_steer_a/bandit.journal.jsonl"))
    return out


def _env() -> dict:
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=ROOT if not path else f"{ROOT}{os.pathsep}{path}")


def run_process(run: Run, out: str) -> int:
    """One run in a fresh interpreter, in the output directory; its exit code."""
    with open(os.path.join(out, run.log), "w") as log:
        proc = subprocess.run(
            [sys.executable, "-m", run.module, *run.args], cwd=out, env=_env(),
            stdout=log, stderr=subprocess.STDOUT, timeout=RUN_TIMEOUT_S,
        )
    return proc.returncode


def _read(path: str) -> Optional[bytes]:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def _diff(a: str, b: str, describe) -> List[str]:
    if describe is not None:
        return describe(a, b)
    x, y = _read(a), _read(b)
    if x is None or y is None:
        return [f"  {b if y is None else a}: missing"]
    return list(difflib.unified_diff(
        x.decode(errors="replace").splitlines(), y.decode(errors="replace").splitlines(),
        a, b, lineterm=""))


def check_leg(leg: Leg, out: str, jobs: int = 1) -> Tuple[bool, List[str]]:
    """Run ``leg`` in ``out``, up to ``jobs`` of its processes at once
    (its runs are independent: each writes its own files); ``(ok, what
    to print on failure)``."""
    from concurrent.futures import ThreadPoolExecutor

    for first, run in leg.needs:
        if not os.path.exists(os.path.join(out, first)):
            run_process(run, out)
    problems = []
    if jobs > 1:
        with ThreadPoolExecutor(jobs) as pool:
            rcs = list(pool.map(lambda r: run_process(r, out), leg.runs))
    else:
        rcs = []
        for run in leg.runs:  # stop at the first failure, as the reference does
            rcs.append(run_process(run, out))
            if rcs[-1] != 0 and not run.may_fail:
                break
    for run, rc in zip(leg.runs, rcs):
        if rc != 0 and not run.may_fail:
            problems.append(f"  {run.module} {' '.join(run.args)} exited {rc}")
    if not problems:
        for name in leg.nonempty:
            blob = _read(os.path.join(out, name))
            if not blob:
                problems.append(f"  {name}: missing or empty")
        for group in leg.same:
            ref = os.path.join(out, group[0])
            for other in group[1:]:
                if _read(ref) != _read(os.path.join(out, other)) or _read(ref) is None:
                    problems += _diff(ref, os.path.join(out, other), leg.describe)
    if not problems:
        return True, []
    logs = []
    for run in leg.runs:
        text = _read(os.path.join(out, run.log))
        if text is not None:
            logs.append(f"--- {run.log}")
            logs.append(text.decode(errors="replace")[-8000:])
    return False, problems + logs


def gate(selected: Sequence[Leg], out: str, jobs: int = 1) -> Tuple[int, dict]:
    """Run the legs in order; ``(exit code, seconds per leg)``. Stops at
    the first failing leg, naming it."""
    seconds = {}
    for leg in selected:
        t0 = time.perf_counter()
        ok, lines = check_leg(leg, out, jobs)
        seconds[leg.name] = round(time.perf_counter() - t0, 3)
        if not ok:
            print(f"determinism gate: FAILED [leg {leg.name}] — {leg.failed}", file=sys.stderr)
            for line in lines:
                print(line, file=sys.stderr)
            return 1, seconds
        print(f"determinism gate: OK [leg {leg.name}] ({leg.ok}) {seconds[leg.name]:.1f} s",
              flush=True)
    return 0, seconds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="check_determinism")
    ap.add_argument("--legs", default=ALL_LEGS,
                    help=f"the legs to run, in the given order (default {ALL_LEGS})")
    ap.add_argument("--out", default=None,
                    help="keep every run's outputs and logs here (default: a "
                         "temporary directory, removed at the end)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="run up to N of a leg's processes at once (default 1: "
                         "one after the other, as the reference does)")
    ap.add_argument("--dump", default=None, help=argparse.SUPPRESS)
    _cli.add_device(ap)
    args = ap.parse_args(argv)
    dev = _cli.device(args, ap.prog)
    if args.dump is not None:
        return _dump_main(args.dump, dev)

    table = legs(str(dev))
    keys = ([LEG_NAMES.get(w, w) for w in args.legs.split(",")]
            if "," in args.legs or args.legs in LEG_NAMES else list(args.legs))
    unknown = sorted(set(keys) - set(table))
    if unknown:
        ap.error(f"unknown legs {unknown}; choose from {ALL_LEGS} or {', '.join(LEG_NAMES)}")
    selected = [table[k] for k in keys]
    out = args.out or tempfile.mkdtemp(prefix="determinism_")
    os.makedirs(out, exist_ok=True)
    try:
        rc, seconds = gate(selected, out, args.jobs)
    finally:
        if args.out is None:
            shutil.rmtree(out, ignore_errors=True)
    _cli.emit({"ok": rc == 0, "legs": seconds, "device": str(dev)}, sort_keys=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
