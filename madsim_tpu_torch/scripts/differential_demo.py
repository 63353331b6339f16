"""The host<->device differential gate (counterpart of
``scripts/differential_demo.py``).

Runs the port's host-tier raft example (``examples/raft_host``, on the
host runtime) and the device raft model (amnesia mode, on ``--device``,
default CUDA) over a matched ``(spec, seed)`` grid — one ``FaultSpec``
compiles to the identical fault schedule on both tiers — for a baseline
crash storm plus one spec per gray-failure family (asymmetric
partitions, fsync-stall + power-fail, clock skew), then asserts:

- outcome distributions (election / no-leader / violation rates) agree
  within the documented per-mille tolerances;
- each tier's recorded election history passes or fails
  ``oracle.specs.ElectionSpec`` exactly when that tier's own online
  violation latch fired;
- the JSON report is canonical (sorted keys, integers only) —
  ``check_determinism`` compares it across two processes.

Usage, from the repository root:
    python -m madsim_tpu_torch.scripts.differential_demo [--seeds N] [--seed0 N]
        [--sim-seconds S] [--specs N] [--report PATH] [--device D]

Exit code: 0 iff every spec's tolerance verdict passed.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import _cli


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="differential_demo", description=__doc__)
    ap.add_argument("--seeds", type=int, default=200)
    ap.add_argument("--seed0", type=int, default=0)
    ap.add_argument("--sim-seconds", type=float, default=2.0)
    ap.add_argument(
        "--specs", type=int, default=0,
        help="run only the first N gate specs (0 = all four)",
    )
    ap.add_argument("--report", default=None, help="write the JSON report here")
    _cli.add_device(ap)
    args = ap.parse_args(argv)
    dev = _cli.device(args, ap.prog)

    from ..explore.differential import DifferentialConfig, gate_specs, run_differential

    dcfg = DifferentialConfig(
        seeds=args.seeds, seed0=args.seed0, sim_seconds=args.sim_seconds
    )
    specs = gate_specs()
    if args.specs:
        specs = specs[: args.specs]
    report = run_differential(specs, dcfg, report_path=args.report, device=dev)

    for rec in report["specs"]:
        fams = {
            k: rec["spec"][k]
            for k in ("crashes", "aparts", "fsync_stalls", "power_fails", "skews")
            if rec["spec"].get(k)
        }
        line = {
            "spec": fams,
            "device": rec["device"],
            "host": rec["host"],
            "deltas": rec["deltas"],
            "pass": rec["pass"],
        }
        print(json.dumps(line, sort_keys=True))
    verdict = "PASS" if report["pass"] else "FAIL"
    print(
        f"differential gate: {verdict} "
        f"({len(report['specs'])} specs x {dcfg.seeds} matched seeds)"
    )
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
