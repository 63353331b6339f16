"""Replay a found failure seed: a full event trace, then the host-tier
reproduction (counterpart of ``scripts/replay_seed.py``).

Usage, from the repository root:
    python -m madsim_tpu_torch.scripts.replay_seed SEED [--host-seeds N] [--volatile] [--device D]
    python -m madsim_tpu_torch.scripts.replay_seed SEED --model etcd --history [--stale-bug]

Runs the flagship Raft sweep config for one seed with full event tracing
(``core.run_traced`` on ``--device``, default CUDA; bit-exact against the
sweep's lane on any device), prints the dispatched event log and the
extracted fault plan, then replays the plan against the port's host-tier
example (``madsim_tpu_torch.examples.raft_host``) scanning N host seeds
for a reproduction — the workflow a user follows when a sweep reports a
violation seed.

``--model etcd`` replays the etcd oracle configuration instead;
``--history`` also dumps the seed's decoded operation history and prints
the linearizability checker's verdict. ``--stale-bug`` seeds the
``bug_stale_read`` defect the history oracle exists to catch.
"""

from __future__ import annotations

import argparse
import sys

from . import _cli


def _print_trace(model_mod, trace, max_events: int) -> None:
    import numpy as np

    from ..replay import _host

    kind_names = {
        getattr(model_mod, name): name[2:]
        for name in dir(model_mod)
        if name.startswith("K_")
    }
    fired = _host(trace["fired"])
    times = _host(trace["time_ns"])
    kinds = _host(trace["kind"])
    pays = _host(trace["pay"])
    idx = np.nonzero(fired)[0]
    print(f"--- first {min(max_events, idx.size)} of {idx.size} dispatched events ---")
    for i in idx[:max_events]:
        name = kind_names.get(int(kinds[i]), str(int(kinds[i])))
        print(f"  t={times[i] / 1e9:9.6f}s {name:<9} pay={[int(x) for x in pays[i][:4]]}")


def _main_etcd(args, dev) -> None:
    from .. import replay
    from ..engine import core
    from ..explore.targets import oracle_demo_faults, stale_etcd_target
    from ..models import etcd
    from ..oracle import KVSpec, check_history, history_bytes

    # the exact (config, faults) the oracle pipeline sweeps (oracle_demo,
    # explore.stale_etcd_target), so a seed the demo reports reproduces
    # here verbatim
    target = stale_etcd_target(bug_stale_read=args.stale_bug)
    workload, ecfg = target.build(oracle_demo_faults())
    final, trace = core.run_traced(workload, ecfg, args.seed, device=dev)
    w = final.wstate
    print(
        f"seed={args.seed} events={int(final.ctr)} "
        f"sim_time={int(final.now_ns) / 1e9:.3f}s puts={int(w.puts)} "
        f"gets={int(w.gets)} violation={bool(w.violation)}"
    )
    _print_trace(etcd, trace, args.events)
    plan = replay.extract_fault_schedule(trace, etcd.K_FAULT)
    print(f"--- fault schedule ({len(plan)} events) ---")
    for t, action, node in plan:
        print(f"  t={t / 1e9:9.6f}s {action:<9} node={node}")
    if args.history:
        hist = replay.extract_history(final)
        print(
            f"--- op history ({len(hist.ops)} ops, {hist.rows} rows, "
            f"overflow={hist.overflow}) ---"
        )
        for op in hist.ops:
            print(f"  {op.describe()}")
        result = check_history(hist, KVSpec())
        if result.ok:
            print(f"history: LINEARIZABLE ({result.states} states explored)")
        else:
            print(f"history: NOT linearizable — {result.reason}")
        sys.stdout.write(f"({len(history_bytes(hist))} canonical bytes)\n")


def _main_raft(args, dev) -> None:
    from .. import replay
    from ..engine import core
    from ..examples import raft_host
    from ..models import raft

    if args.volatile:
        cfg, ecfg = replay.amnesia_raft_config()
    else:
        cfg = raft.RaftConfig(num_nodes=5, crashes=1)
        ecfg = raft.engine_config(cfg, time_limit_ns=3_000_000_000, max_steps=30_000)

    final, trace = core.run_traced(raft.workload(cfg), ecfg, args.seed, device=dev)
    w = final.wstate
    print(
        f"seed={args.seed} events={int(final.ctr)} "
        f"sim_time={int(final.now_ns) / 1e9:.3f}s "
        f"elections={int(w.elections)} violation={bool(w.violation)}"
    )
    _print_trace(raft, trace, args.events)

    plan = replay.extract_fault_schedule(trace, raft.K_FAULT)
    print(f"--- fault schedule ({len(plan)} events) ---")
    for t, action, node in plan:
        print(f"  t={t / 1e9:9.6f}s {action:<9} node={node}")

    if not plan:
        print("no faults in this seed's schedule; nothing to replay on host")
        return
    print(f"--- host-tier replay (scanning {args.host_seeds} host seeds) ---")
    result = replay.replay_on_host(
        lambda hs, p: raft_host.run_seed_with_plan(
            hs, p, n=cfg.num_nodes, sim_seconds=3.0
        ),
        plan,
        host_seeds=range(args.host_seeds),
    )
    if result is None:
        print("no host-tier reproduction in the scanned seeds "
              "(within-tier CPU trace above is the bit-exact artifact)")
    else:
        print(
            f"REPRODUCED on host_seed={result['host_seed']}: "
            f"violations={result['violations']} "
            f"elections={result['leaders_elected']} msgs={result['msgs']}"
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="replay_seed")
    ap.add_argument("seed", type=int)
    ap.add_argument("--model", choices=("raft", "etcd"), default="raft")
    ap.add_argument("--host-seeds", type=int, default=10)
    ap.add_argument(
        "--volatile", action="store_true",
        help="amnesia config (crash wipes durable state — the host example's semantics)",
    )
    ap.add_argument(
        "--history", action="store_true",
        help="dump the decoded op history + linearizability verdict (etcd model)",
    )
    ap.add_argument(
        "--stale-bug", action="store_true",
        help="seed the etcd stale-read bug the history oracle catches",
    )
    ap.add_argument("--events", type=int, default=30, help="trace lines to print")
    _cli.add_device(ap)
    args = ap.parse_args(argv)

    if args.model == "etcd":
        if args.volatile:
            ap.error("--volatile is the raft amnesia config (default model)")
        _main_etcd(args, _cli.device(args, ap.prog))
    else:
        if args.history:
            ap.error(
                "--history needs a history-recording workload; the raft "
                "model records none (use --model etcd)"
            )
        if args.stale_bug:
            ap.error("--stale-bug seeds the etcd defect (use --model etcd)")
        _main_raft(args, _cli.device(args, ap.prog))
    return 0


if __name__ == "__main__":
    sys.exit(main())
