"""Fleet orchestrator smoke: shared store, kill -9 reclaim, replay gate
(counterpart of ``scripts/fleet_smoke.py``).

Usage, from the repository root:
    python -m madsim_tpu_torch.scripts.fleet_smoke [--outdir DIR] [--device D]   # the full drill
    python -m madsim_tpu_torch.scripts.fleet_smoke --merged-only --workers N --report PATH
    (internal) python -m madsim_tpu_torch.scripts.fleet_smoke --worker --store DIR ...

The full drill runs every leg in a separate process, each on ``--device``
(default CUDA; worker processes share the card):

1. a solo worker sweeps the whole unit plan into a fresh store and
   writes the merged fleet report — the reference bytes;
2. two independent workers share a second store (the first capped to
   half the units, so each runs only part of the plan): the merged
   report must be byte-identical to the solo run, and the merged
   distinct-fingerprint count must be strictly greater than what either
   worker found alone;
3. the kill drill: a worker on a third store is killed by ``os._exit``
   (code 137) mid-append after one unit (torn final record, no done
   marker, a lease left to expire); a second worker quarantines nothing
   (torn tails drop), reclaims the dead worker's unit, re-runs it, and
   the merged report still matches the solo bytes;
4. the regression gate replays every stored bug bit-exactly inside each
   later worker's startup (their JSON output carries the verdict).

``--merged-only`` is the determinism gate's fleet leg: run the plan on a
fresh store with N workers and write the merged report — the gate
compares it across 2 driver processes x 2 worker counts.

Exit code 0 = every check held. Stdout's last line is a JSON summary;
progress goes to stderr. A worker's failure is its nonzero exit code.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

from . import _cli

# the pinned drill config (the reference's: campaign seed 7 spreads the
# two raft-amnesia fingerprints across the two halves of a 4-unit plan)
UNITS = 4
CFG = dict(seeds_per_round=24, batch=2, chunk_size=24,
           campaign_seed=7, max_recorded_seeds=4)
TARGET_KW = dict(time_limit_ns=1_500_000_000, max_steps=15_000, hist_slots=0)
SHRINK_TESTS = 24
# the repository root, on the children's PYTHONPATH for ``python -m``
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _build():
    from ..engine.faults import FaultSpec
    from ..explore import CampaignConfig, amnesia_raft_target

    target = amnesia_raft_target(**TARGET_KW)
    base = FaultSpec(
        crashes=3, crash_window_ns=1_200_000_000,
        restart_lo_ns=50_000_000, restart_hi_ns=300_000_000,
    )
    return target, base, CampaignConfig(**CFG)


def worker_main(args, dev) -> None:
    """One fleet worker process (the internal --worker mode)."""
    from ..explore import CorpusStore, run_worker

    target, base, ccfg = _build()
    store = CorpusStore(args.store, worker=args.name, ttl_s=args.ttl)
    res = run_worker(
        target, base, ccfg, store, args.units,
        max_units=args.max_units, shrink_tests=SHRINK_TESTS,
        skip_gate=args.skip_gate,
        _crash_after_units=args.crash_after, device=dev,
    )
    reader = CorpusStore(args.store, worker=f"{args.name}-read")
    _, stats = reader.read_records()
    out = {
        "worker": args.name,
        "units": res["units"],
        "fingerprints": res["fingerprints"],
        "gate": res["gate"],
        "stats": {
            "lines": stats.lines,
            "quarantined": stats.quarantined,
            "truncated_logs": stats.truncated_logs,
        },
    }
    print(json.dumps(out, sort_keys=True))


def report_main(args) -> None:
    """Write the merged fleet report (the internal --report-only mode —
    import-only, no sweeps, so the drivers stay light)."""
    from ..explore import CorpusStore, write_merged

    write_merged(CorpusStore(args.store, worker="report"), args.report)


def _env() -> dict:
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=ROOT if not path else f"{ROOT}{os.pathsep}{path}")


def _cmd(*extra: str) -> list:
    return [sys.executable, "-m", "madsim_tpu_torch.scripts.fleet_smoke", *extra]


def _spawn(store: str, name: str, device: str, *extra: str) -> subprocess.Popen:
    cmd = _cmd("--worker", "--store", store, "--name", name, "--units", str(UNITS),
               "--device", device, *extra)
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=sys.stderr, text=True, env=_env(),
    )


def _run_worker_proc(store: str, name: str, device: str, *extra: str) -> dict:
    p = _spawn(store, name, device, *extra)
    out, _ = p.communicate(timeout=900)
    if p.returncode != 0:
        raise SystemExit(f"worker {name} failed rc={p.returncode}")
    print(f"[fleet-smoke] worker {name} done", file=sys.stderr)
    return json.loads(out.strip().splitlines()[-1])


def _write_report(store: str, path: str) -> str:
    subprocess.run(
        _cmd("--report-only", "--store", store, "--report", path),
        check=True, env=_env(),
    )
    with open(path) as f:
        return f.read()


def merged_only(args, device: str) -> None:
    """The determinism-leg mode: N workers over a fresh store, merged
    report to --report. Bytes must not depend on N (the gate compares)."""
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        half = -(-UNITS // args.workers)
        for i in range(args.workers):
            extra = [] if i == args.workers - 1 else ["--max-units", str(half)]
            _run_worker_proc(
                store, f"w{i}", device, *extra, *(["--skip-gate"] if i else [])
            )
        _write_report(store, args.report)


def drill(args, device: str) -> None:
    outdir = args.outdir or tempfile.mkdtemp(prefix="fleet_smoke_")
    os.makedirs(outdir, exist_ok=True)
    summary: dict = {}

    # leg 1: solo reference
    s_solo = os.path.join(outdir, "solo")
    solo = _run_worker_proc(s_solo, "solo", device)
    ref = _write_report(s_solo, os.path.join(outdir, "merged_solo.jsonl"))
    _cli.check(solo["units"] == list(range(UNITS)), str(solo))
    _cli.check(bool(solo["fingerprints"]), "solo run found no bugs; drill is vacuous")
    summary["solo_fps"] = solo["fingerprints"]

    # leg 2: two independent processes share one store; merged bytes
    # identical to solo, fingerprint union strictly above either share
    s_shared = os.path.join(outdir, "shared")
    wa = _run_worker_proc(s_shared, "wa", device, "--max-units", str(UNITS // 2))
    wb = _run_worker_proc(s_shared, "wb", device)
    shared = _write_report(s_shared, os.path.join(outdir, "merged_shared.jsonl"))
    _cli.check(shared == ref, "shared-store merged bytes diverged from solo")
    merged_fps = sorted(
        json.loads(ln)["key"] for ln in ref.splitlines()
        if json.loads(ln).get("kind") == "bug"
    )
    _cli.check(len(merged_fps) > len(wa["fingerprints"]), str((merged_fps, wa)))
    _cli.check(len(merged_fps) > len(wb["fingerprints"]), str((merged_fps, wb)))
    _cli.check(set(wa["fingerprints"]) | set(wb["fingerprints"]) == set(merged_fps),
               str((merged_fps, wa["fingerprints"], wb["fingerprints"])))
    # worker B's startup gate replayed worker A's stored bugs bit-exactly
    _cli.check(wa["gate"]["ok"] and wa["gate"]["checked"] == 0, str(wa["gate"]))
    _cli.check(wb["gate"]["ok"] and wb["gate"]["checked"] >= 1, str(wb["gate"]))
    summary["wa_fps"] = wa["fingerprints"]
    summary["wb_fps"] = wb["fingerprints"]
    summary["merged_fps"] = merged_fps
    summary["gate_checked"] = wb["gate"]["checked"]

    # leg 3: kill -9 mid-append + reclaim
    s_kill = os.path.join(outdir, "kill")
    p = _spawn(s_kill, "victim", device, "--crash-after", "1", "--ttl", "1")
    p.communicate(timeout=900)
    _cli.check(p.returncode == 137, f"victim exited {p.returncode}, wanted 137")
    print("[fleet-smoke] victim killed mid-append", file=sys.stderr)
    rec = _run_worker_proc(s_kill, "reclaimer", device, "--ttl", "1")
    killed = _write_report(s_kill, os.path.join(outdir, "merged_kill.jsonl"))
    _cli.check(killed == ref, "kill-and-reclaim merged bytes diverged from solo")
    # the victim's torn final record was dropped, not quarantined, and
    # its unleased units (everything it never finished) were re-run
    _cli.check(rec["stats"]["truncated_logs"] >= 1, str(rec["stats"]))
    _cli.check(rec["stats"]["quarantined"] == 0, str(rec["stats"]))
    _cli.check(rec["gate"]["ok"], str(rec["gate"]))
    summary["reclaimer_units"] = rec["units"]
    summary["reclaimer_gate"] = rec["gate"]

    summary["merged_bytes"] = len(ref)
    summary["ok"] = True
    print(json.dumps(summary, sort_keys=True))
    print(f"[fleet-smoke] OK ({outdir})", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fleet_smoke")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--report-only", action="store_true")
    ap.add_argument("--merged-only", action="store_true")
    ap.add_argument("--store", type=str)
    ap.add_argument("--name", type=str, default=None)
    ap.add_argument("--units", type=int, default=UNITS)
    ap.add_argument("--max-units", type=int, default=None)
    ap.add_argument("--crash-after", type=int, default=None)
    ap.add_argument("--ttl", type=float, default=30.0)
    ap.add_argument("--skip-gate", action="store_true")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--report", type=str, default=None)
    ap.add_argument("--outdir", type=str, default=None)
    _cli.add_device(ap)
    args = ap.parse_args(argv)
    if args.report_only:
        report_main(args)
        return 0
    # every other mode sweeps: refuse here, before any worker starts
    dev = _cli.device(args, ap.prog)
    if args.worker:
        worker_main(args, dev)
    elif args.merged_only:
        merged_only(args, str(dev))
    else:
        drill(args, str(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
