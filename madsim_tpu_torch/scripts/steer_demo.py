"""Self-steering scheduler smoke: adaptive-vs-uniform A/B + replay gate
(counterpart of ``scripts/steer_demo.py``).

Usage, from the repository root:
    python -m madsim_tpu_torch.scripts.steer_demo [--device D]        # the full drill
    python -m madsim_tpu_torch.scripts.steer_demo --policy bandit --budget 30000 \\
        --report PATH --trace PATH [--telemetry-dir DIR]              # one pinned run

The full drill runs on the raft-amnesia steering gate
(``explore.targets.steer_gate``), all in one process on ``--device``
(default CUDA):

1. the bandit campaign runs twice — once with telemetry journaling on,
   once fully off — and the campaign report and the decision trace must
   be byte-identical (replay determinism + telemetry out-of-band-ness in
   one shot);
2. the decision trace is present and structurally complete: cold + UCB
   decisions, absorbed outcomes in submission order, at least one budget
   escalation and one early-kill at the pinned config;
3. the run journal carries one ``steer_round`` event per decision and
   per outcome (the trace's out-of-band mirror);
4. the uniform grid runs at the same deterministic device-event budget
   (the matched-compute baseline) and the bandit must find >= 1.5x its
   distinct triage fingerprints.

``--policy/--report/--trace`` is the determinism gate's steering leg:
one pinned campaign, report + trace written for the gate to compare
across 2 driver processes x telemetry {on, off}.

Exit code 0 = every check held. Stdout's last line is a JSON summary;
progress goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from . import _cli

# the pinned drill config (the reference's): 10 families, 2 of them
# crash-bearing — the uniform grid burns most of the budget on
# amnesia-blind duds, while the bandit early-kills them and pours the
# freed budget into escalated crash candidates
FAMILIES = (0x001, 0x002, 0x003, 0x004, 0x008,
            0x010, 0x020, 0x040, 0x080, 0x100)
SEEDS_PER_ROUND = 16
MAX_RECORDED = 8
ESCALATE_SEEDS = 8
KILL_PLAYS = 1  # kill a family after one barren play: max pruning
BUDGET_EVENTS = 45_000
CAMPAIGN_SEED = 7


def _cfgs(policy: str, budget: int):
    from ..explore import CampaignConfig, SteerConfig

    ccfg = CampaignConfig(
        rounds=999, seeds_per_round=SEEDS_PER_ROUND,
        campaign_seed=CAMPAIGN_SEED, max_recorded_seeds=MAX_RECORDED,
        scheduler=policy,
    )
    scfg = SteerConfig(
        scheduler=policy, families=FAMILIES,
        escalate_seeds=ESCALATE_SEEDS, kill_plays=KILL_PLAYS,
        budget_events=budget,
    )
    return ccfg, scfg


def _run(policy: str, budget: int, report: str, trace: str,
         telemetry_dir, dev):
    from ..explore import run_steered
    from ..explore.targets import steer_gate

    target, base = steer_gate(smoke=True)
    ccfg, scfg = _cfgs(policy, budget)
    telemetry = None
    if telemetry_dir is not None:
        from ..obs import Telemetry

        telemetry = Telemetry(
            journal=os.path.join(telemetry_dir, f"{policy}.journal.jsonl")
        )
    try:
        return run_steered(
            target, base, ccfg, scfg,
            report_path=report, trace_path=trace, telemetry=telemetry, device=dev,
        )
    finally:
        if telemetry is not None:
            telemetry.close()


def single(args, dev) -> None:
    """One pinned run — the determinism gate's steering leg."""
    res = _run(args.policy, args.budget, args.report, args.trace,
               args.telemetry_dir, dev)
    print(json.dumps({
        "policy": args.policy,
        "decisions": len(res.records),
        "fingerprints": res.fingerprints,
        "spent_events": res.spent_events,
    }, sort_keys=True))


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def drill(args, dev) -> None:
    from ..obs import read_journal

    outdir = args.outdir or tempfile.mkdtemp(prefix="steer_smoke_")
    os.makedirs(outdir, exist_ok=True)
    p = lambda n: os.path.join(outdir, n)  # noqa: E731
    summary: dict = {}

    # legs 1-3: bandit twice (journal on / telemetry off), bytes compared
    print("[steer-smoke] bandit run (journal on)", file=sys.stderr)
    _run("bandit", args.budget, p("bandit.jsonl"), p("bandit.trace.jsonl"), outdir, dev)
    print("[steer-smoke] bandit replay (telemetry off)", file=sys.stderr)
    _run("bandit", args.budget, p("replay.jsonl"), p("replay.trace.jsonl"), None, dev)
    report = _read(p("bandit.jsonl"))
    trace = _read(p("bandit.trace.jsonl"))
    _cli.check(report == _read(p("replay.jsonl")),
               "bandit campaign report bytes diverged on replay")
    _cli.check(trace == _read(p("replay.trace.jsonl")),
               "bandit decision-trace bytes diverged on replay")

    recs = [json.loads(ln) for ln in trace.splitlines()[1:]]
    kinds = [r["kind"] for r in recs]
    decides = [r for r in recs if r["kind"] == "decide"]
    outcomes = [r for r in recs if r["kind"] == "outcome"]
    _cli.check(bool(decides and outcomes), "decision trace is empty")
    _cli.check([r["i"] for r in outcomes] == list(range(len(outcomes))),
               "outcomes not absorbed in submission order")
    _cli.check(any(r["why"] == "ucb" for r in decides), "bandit never exploited")
    _cli.check("escalate" in kinds, "no family escalated at the pinned config")
    _cli.check("kill" in kinds, "no family early-killed at the pinned config")
    summary["decisions"] = len(decides)
    summary["kills"] = kinds.count("kill")
    summary["escalations"] = kinds.count("escalate")

    journal = [
        r for r in read_journal(p("bandit.journal.jsonl"))
        if r.get("kind") == "steer_round"
    ]
    _cli.check(len(journal) == len(decides) + len(outcomes),
               f"journal carries {len(journal)} steer_round events, trace has "
               f"{len(decides)}+{len(outcomes)}")

    # leg 4: the matched-budget uniform grid
    print("[steer-smoke] uniform baseline", file=sys.stderr)
    uni = _run("uniform", args.budget, p("uniform.jsonl"), p("uniform.trace.jsonl"),
               None, dev)
    bandit_fps = [json.loads(ln) for ln in report.splitlines()[1:]]
    bandit_fps = sorted({fp for r in bandit_fps for fp in r["fresh_fingerprints"]})
    summary["bandit_fps"] = bandit_fps
    summary["uniform_fps"] = uni.fingerprints
    _cli.check(bool(bandit_fps), "bandit found no fingerprints; drill is vacuous")
    _cli.check(2 * len(bandit_fps) >= 3 * len(uni.fingerprints),
               f"adaptive/uniform fingerprint ratio below 1.5x: "
               f"{bandit_fps} vs {uni.fingerprints}")

    summary["ok"] = True
    print(json.dumps(summary, sort_keys=True))
    print(f"[steer-smoke] OK ({outdir})", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="steer_demo")
    ap.add_argument("--policy", choices=("bandit", "uniform"), default=None)
    ap.add_argument("--budget", type=int, default=BUDGET_EVENTS)
    ap.add_argument("--report", type=str, default=None)
    ap.add_argument("--trace", type=str, default=None)
    ap.add_argument("--telemetry-dir", type=str, default=None)
    ap.add_argument("--outdir", type=str, default=None)
    _cli.add_device(ap)
    args = ap.parse_args(argv)
    if args.policy is not None:
        if not (args.report and args.trace):
            ap.error("--policy needs --report and --trace")
        single(args, _cli.device(args, ap.prog))
    else:
        drill(args, _cli.device(args, ap.prog))
    return 0


if __name__ == "__main__":
    sys.exit(main())
