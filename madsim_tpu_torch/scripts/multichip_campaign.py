"""Sharded campaign + world-size curve (counterpart of
``scripts/multichip_campaign.py``).

Two phases, both through the sharded pipelined checked-sweep driver
(``parallel.run_sweep_sharded_pipelined``), inside one
``parallel.World`` of as many ranks as the largest world size asked for
(``--devices``): on ``--device cuda`` (the default) the ranks sit
round-robin on the visible cards, sharing one over gloo when there are
more ranks than cards; ``--device cpu`` runs them on the CPU.

1. **curve** — one fixed-spec checked sweep (sweep + screen + WGL
   checking) at each world size in ``--devices``, same seed range;
   prints aggregate seeds/s, events/s and time-to-first-bug per size and
   asserts the merged summary bytes are identical across every size
   (the invariance contract, computed as the reference computes it:
   where ``hist_unique`` moves with the chunking, the reference's own
   check fails, and so does this one).
2. **campaign** — a coverage-guided fault campaign over
   ``--campaign-seeds`` total seeds at the largest world size.
   ``--campaign-invariance`` also re-runs a small campaign at the
   smallest and largest world sizes and compares the JSONL reports'
   sha256.

``--smoke`` shrinks every knob to a CI gate. Wall-clock metrics go to
stdout JSON; the compared artifacts (checked-sweep totals, campaign
JSONL) never contain times or paths.

Usage, from the repository root:
    python -m madsim_tpu_torch.scripts.multichip_campaign [--smoke] [--devices 1,2,4,8] [--device D] ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from . import _cli


def _target(kind: str, smoke: bool):
    from ..explore.targets import amnesia_gate, oracle_demo_faults, stale_etcd_target

    if kind == "raft":
        return amnesia_gate(smoke)
    t = stale_etcd_target(
        time_limit_ns=500_000_000 if smoke else 2_000_000_000,
        max_steps=6_000 if smoke else 20_000,
        hist_slots=128 if smoke else 256,
    )
    return t, oracle_demo_faults()


def curve_job(mesh, args, counts):
    """Phase 1 on every rank; each returns rank 0's curve."""
    from ..explore import checked_sweep_curve

    target, base = _target(args.curve_target, args.smoke)
    return checked_sweep_curve(
        target, base, device_counts=counts, seeds_total=args.curve_seeds,
        chunk_per_device=args.chunk_per_device, workers=args.workers, mesh=mesh,
    )


def campaign_job(mesh, args, n_dev: int, tmp: str):
    """Phase 2 on every rank; each returns rank 0's results."""
    from ..explore import CampaignConfig, sharded_campaign

    out = {}
    if args.campaign_seeds:
        ctarget, cbase = _target("raft", args.smoke)
        rounds = -(-args.campaign_seeds // args.seeds_per_round)
        ccfg = CampaignConfig(
            rounds=rounds,
            seeds_per_round=args.seeds_per_round,
            chunk_size=args.chunk_per_device * n_dev,
            check_workers=args.workers,
        )
        out["campaign"] = sharded_campaign(
            ctarget, cbase, ccfg, n_dev, ckpt_dir=args.campaign_ckpt_dir, mesh=mesh,
        )
    if args.campaign_invariance:
        lo_hi = (args.lo, n_dev)
        ctarget, cbase = _target("raft", True)
        ccfg = CampaignConfig(
            rounds=2, seeds_per_round=256,
            chunk_size=128 * max(lo_hi), check_workers=args.workers,
        )
        shas = {}
        for nd in lo_hi:
            p = os.path.join(tmp, f"campaign_{nd}.jsonl")
            res = sharded_campaign(ctarget, cbase, ccfg, nd, report_path=p, mesh=mesh)
            shas[nd] = res["report_sha256"]
        out["shas"] = shas
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="multichip_campaign")
    ap.add_argument("--devices", default="1,2,4,8",
                    help="comma-separated world sizes for the curve")
    ap.add_argument("--curve-target", choices=("raft", "etcd"), default="raft")
    ap.add_argument("--curve-seeds", type=int, default=4096)
    ap.add_argument("--chunk-per-device", type=int, default=512)
    ap.add_argument("--workers", type=int, default=0,
                    help="history-checker process-pool size")
    ap.add_argument("--campaign-seeds", type=int, default=0,
                    help="total seeds of the big sharded campaign "
                         "(rounds x seeds-per-round; 0 = skip)")
    ap.add_argument("--seeds-per-round", type=int, default=65536)
    ap.add_argument("--campaign-ckpt-dir", default=None)
    ap.add_argument("--campaign-invariance", action="store_true",
                    help="re-run a small campaign at the smallest and "
                         "largest world sizes and compare reports")
    ap.add_argument("--report", default=None)
    ap.add_argument("--smoke", action="store_true")
    _cli.add_device(ap)
    args = ap.parse_args(argv)

    counts = tuple(int(x) for x in args.devices.split(","))
    if args.smoke:
        counts = tuple(c for c in counts if c <= 2) or (1, 2)
        args.curve_seeds = min(args.curve_seeds, 512)
        args.chunk_per_device = min(args.chunk_per_device, 128)
        args.campaign_invariance = True
    dev = _cli.device(args, ap.prog)
    args.lo = min(counts)

    from ..parallel import World
    from . import multichip_campaign as this  # the ranks import it by name

    n_dev = max(counts)
    with World(n_dev, device=dev.type) as world, tempfile.TemporaryDirectory() as tmp:
        curve = world.run(this.curve_job, args, counts)[0]
        if not curve["bytes_invariant"]:
            raise AssertionError(
                "sharded checked-sweep summary bytes differ across mesh sizes"
            )
        # the reference's keys (the port's curve also says whether the
        # sizes agree but for hist_unique, ROADMAP "Recorded, not port faults")
        curve.pop("invariant_but_hist_unique", None)
        out = {"backend": _cli.device_name(dev), "curve": curve}
        if args.campaign_seeds or args.campaign_invariance:
            res = world.run(this.campaign_job, args, n_dev, tmp)[0]
            if "campaign" in res:
                out["campaign"] = res["campaign"]
            if args.campaign_invariance:
                shas = res["shas"]
                if len(set(shas.values())) != 1:
                    raise AssertionError(
                        f"campaign report bytes differ across mesh sizes: {shas}"
                    )
                out["campaign_invariance"] = {
                    "device_counts": [args.lo, n_dev],
                    "report_sha256": next(iter(shas.values())),
                    "bytes_invariant": True,
                }

    blob = json.dumps(out, sort_keys=True)
    if args.report:
        with open(args.report, "w") as f:
            f.write(blob + "\n")
    print(blob)
    return 0


if __name__ == "__main__":
    sys.exit(main())
