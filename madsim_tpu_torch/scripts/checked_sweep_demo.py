"""Screened + pipelined checked-sweep demo (and a determinism-gate leg;
counterpart of ``scripts/checked_sweep_demo.py``).

Runs the etcd history workload (seeded ``bug_stale_read`` by default)
through ``oracle.screen.checked_sweep`` on ``--device`` (default CUDA):
the chunked sweep with the device screen behind each chunk, host-side
decode + WGL checking of each chunk's suspects, optionally fanned over a
process pool.

The report written by ``--report`` is deterministic by contract: a pure
function of (config, seed range) — no wall times, no paths, keys sorted —
and neither the pool size, the mesh, the driver, the decode route nor
telemetry may change a byte of it; ``check_determinism`` runs it in two
processes under each of those and compares the bytes. Timing goes to
stderr, where the gate ignores it.

Usage, from the repository root:
    python -m madsim_tpu_torch.scripts.checked_sweep_demo [--seeds N] [--chunk-size C]
        [--workers W] [--clean] [--report PATH] [--mesh N]
        [--driver chunked|stream] [--telemetry-dir DIR] [--device-decode] [--device D]

``--device-decode`` sources canonical history rows from the device
decode (``oracle.history.canon_sweep``) instead of per-row host Python.
``--telemetry-dir DIR`` runs under a full ``obs.Telemetry`` handle
(metrics, journal and trace spans written to DIR). ``--driver stream``
routes the pipeline through the streaming lane pool
(``engine.stream.stream_sweep``). ``--mesh N`` shards it over N ranks:
one rank runs in this process, more run as a ``parallel.World`` whose
ranks share the visible cards (or the CPU with ``--device cpu``), rank 0
holding the telemetry handle.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import _cli


def _pipeline(mesh, args, device):
    """``(totals, wall s)`` of the checked sweep on this process or on
    one rank of a world (``mesh``)."""
    import numpy as np

    from ..models import etcd
    from ..oracle.screen import checked_sweep

    cfg = etcd.EtcdConfig(hist_slots=256, bug_stale_read=not args.clean)
    ecfg = etcd.engine_config(cfg, time_limit_ns=2_000_000_000, max_steps=20_000)
    wl = etcd.workload(cfg)
    seeds = np.arange(args.seed0, args.seed0 + args.seeds, dtype=np.int64)

    telem = None
    if args.telemetry_dir and (mesh is None or mesh.rank == 0):
        from .. import obs

        os.makedirs(args.telemetry_dir, exist_ok=True)
        telem = obs.Telemetry(
            journal=os.path.join(args.telemetry_dir, "journal.jsonl"),
            trace=os.path.join(args.telemetry_dir, "trace.json"),
        )
    t0 = time.perf_counter()
    totals = checked_sweep(
        wl, ecfg, seeds, etcd.history_spec(), etcd.sweep_summary,
        chunk_size=args.chunk_size, workers=args.workers, mesh=mesh,
        driver=args.driver, telemetry=telem,
        device_decode=args.device_decode,
        device=device if mesh is None else mesh.device,
    )
    wall = time.perf_counter() - t0
    if telem is not None:
        telem.close()
    return totals, wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="checked_sweep_demo")
    ap.add_argument("--seeds", type=int, default=512)
    ap.add_argument("--seed0", type=int, default=0)
    ap.add_argument("--chunk-size", type=int, default=128)
    ap.add_argument("--workers", type=int, default=0)
    ap.add_argument(
        "--clean", action="store_true",
        help="default config (no seeded bug): the checker must stay quiet",
    )
    ap.add_argument("--report", default=None)
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard the pipeline over N ranks")
    ap.add_argument(
        "--driver", choices=("chunked", "stream"), default="chunked",
        help="sweep driver; the report bytes must not depend on this "
        "(the gate's streaming leg compares the two)",
    )
    ap.add_argument(
        "--telemetry-dir", default=None,
        help="run under a full obs.Telemetry handle (metrics + journal + "
        "trace written HERE); the report bytes must not depend on this "
        "(the gate's telemetry leg compares on and off)",
    )
    ap.add_argument(
        "--device-decode", action="store_true",
        help="source canonical history rows from the device decode "
        "instead of per-row host Python; the report bytes must not depend "
        "on this (the gate's decode leg compares the two)",
    )
    _cli.add_device(ap)
    args = ap.parse_args(argv)
    dev = _cli.device(args, ap.prog)

    if args.mesh > 1:
        from ..parallel import World
        from . import checked_sweep_demo as this  # the ranks import it by name

        with World(args.mesh, device=dev.type) as world:
            totals, wall = world.run(this._pipeline, args, None)[0]
    else:
        mesh = None
        if args.mesh == 1:
            from ..parallel import seed_mesh

            mesh = seed_mesh(device=dev)
        totals, wall = _pipeline(mesh, args, dev)

    report = {
        "metric": "etcd_checked_sweep",
        "config": "clean" if args.clean else "bug_stale_read",
        "seed_range": [args.seed0, args.seed0 + args.seeds],
        "chunk_size": args.chunk_size,
        "totals": totals,
    }
    if args.report:
        with open(args.report, "w") as f:
            f.write(json.dumps(report, sort_keys=True) + "\n")
    else:
        print(json.dumps(report, sort_keys=True))
    print(
        f"checked {args.seeds} seeds in {wall:.2f}s "
        f"({args.seeds / wall:.1f} seeds/s end-to-end; "
        f"{totals['hist_suspects']} suspects, "
        f"{totals['hist_violations']} violations, "
        f"workers={args.workers}, backend={_cli.device_name(dev)})",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
