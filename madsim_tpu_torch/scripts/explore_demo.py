"""End-to-end explore demo: bland spec -> campaign -> triage -> shrink
(counterpart of ``scripts/explore_demo.py``).

Usage, from the repository root:
    python -m madsim_tpu_torch.scripts.explore_demo [--rounds N] [--seeds-per-round N]
        [--campaign-seed N] [--report PATH] [--ckpt-dir DIR] [--no-shrink]
        [--assert-zero-recompile] [--telemetry-dir DIR] [--device D]

Runs the full find->triage->shrink loop against the amnesia Raft target
on ``--device`` (default CUDA): starting from a bland one-crash
``FaultSpec``, the coverage-guided campaign mutates its way to a
violating ``(spec, seed)``, triage assigns the failure a stable
fingerprint, and the shrinker emits a minimal ``FixedFaults`` schedule
re-verified by bit-exact ``run_traced`` replay.

``--report`` writes the campaign's JSONL report — deterministic bytes per
campaign seed (``check_determinism`` runs this twice and compares the
bytes; wall-clock and environment facts stay out of that file). The
human-readable summary on stdout is not part of that contract.

``--assert-zero-recompile`` warms with a one-round campaign first and
fails unless the full campaign then counts 0 in
``engine/compiles.count_compiles`` (kernel builds and library loads: the
warm-up launches the pop-min kernel on a card, so none lands in the
campaign). Without it, ``compiles_in_campaign`` counts the first load.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import _cli


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="explore_demo")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--seeds-per-round", type=int, default=128)
    ap.add_argument("--campaign-seed", type=int, default=1)
    ap.add_argument("--report", type=str, default=None, help="JSONL report path")
    ap.add_argument("--ckpt-dir", type=str, default=None,
                    help="per-round sweep checkpoints (resumable campaigns)")
    ap.add_argument("--no-shrink", action="store_true",
                    help="stop after the campaign (the cheap determinism leg)")
    ap.add_argument("--assert-zero-recompile", action="store_true",
                    help="warm with a one-round campaign, then FAIL unless "
                         "the full campaign runs with 0 kernel builds or "
                         "loads (the spec-as-data contract)")
    ap.add_argument("--telemetry-dir", type=str, default=None,
                    help="run the campaign under a full obs.Telemetry "
                         "handle (metrics + journal written here); must "
                         "not change a report byte")
    _cli.add_device(ap)
    args = ap.parse_args(argv)
    dev = _cli.device(args, ap.prog)

    from .. import explore
    from ..engine.compiles import count_compiles
    from ..engine.faults import FaultSpec
    from ..models._common import coverage_bit_count

    t0 = time.perf_counter()
    target = explore.amnesia_raft_target()
    bland = FaultSpec(
        crashes=1,
        crash_window_ns=2_000_000_000,
        restart_lo_ns=50_000_000,
        restart_hi_ns=300_000_000,
    )
    ccfg = explore.CampaignConfig(
        rounds=args.rounds,
        seeds_per_round=args.seeds_per_round,
        campaign_seed=args.campaign_seed,
        stop_after_failures=1,
    )
    if args.assert_zero_recompile:
        # one round of the same campaign loads every kernel the full run
        # launches; every later candidate is data
        explore.run_campaign(target, bland, ccfg._replace(rounds=1), device=dev)
    telem = None
    if args.telemetry_dir:
        from .. import obs

        os.makedirs(args.telemetry_dir, exist_ok=True)
        telem = obs.Telemetry(
            journal=os.path.join(args.telemetry_dir, "journal.jsonl"),
        )
    with count_compiles() as compiles:
        result = explore.run_campaign(
            target, bland, ccfg, report_path=args.report,
            ckpt_dir=args.ckpt_dir, telemetry=telem, device=dev,
        )
    if telem is not None:
        telem.close()
    out = {
        "metric": "explore_demo",
        "rounds_run": len(result.records),
        "corpus_size": len(result.corpus),
        "coverage_bits": coverage_bit_count(result.coverage_map),
        "failures_found": len(result.failures),
        # kernel builds and loads the campaign itself performed (0 after
        # the --assert-zero-recompile warm-up — engine/compiles.py)
        "compiles_in_campaign": compiles.count,
    }
    if args.assert_zero_recompile and compiles.count != 0:
        print(
            f"explore demo: campaign recompiled {compiles.count}x after "
            "warm-up — the spec-as-data zero-recompile contract is broken",
            file=sys.stderr,
        )
        return 1
    if result.failures:
        spec, seed = result.failures[0]
        # triage each seed under the spec it was found with (failures can
        # span rounds — and thus specs — when stop_after_failures > 1)
        buckets: dict = {}
        for fspec, fseed in result.failures:
            for fp, fails in explore.triage(target, fspec, [fseed], device=dev).items():
                buckets.setdefault(fp, []).extend(fails)
        out["fingerprints"] = explore.fingerprint_counts(buckets)
        if not args.no_shrink:
            sr = explore.shrink(target, spec, seed, device=dev)
            if sr is None:
                raise RuntimeError("shrink lost the failure it was given")
            out["shrunk"] = {
                "seed": sr.seed,
                "fingerprint": sr.fingerprint,
                "schedule": [list(e) for e in sr.schedule],
                "events_before": sr.original_len,
                "events_after": len(sr.schedule),
                "replays": sr.tests,
            }
    out["wall_s"] = round(time.perf_counter() - t0, 2)
    print(json.dumps(out, sort_keys=True))
    if not result.failures:
        print("explore demo: campaign found no violating seed in budget",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
