"""History-oracle demo: sweep -> check -> triage -> shrink -> byte-compare
(counterpart of ``scripts/oracle_demo.py``).

The end-to-end acceptance path of the history oracle, on ``--device``
(default CUDA):

1. sweep the seeded etcd stale-read bug config over a pinned seed range
   and decode every lane's recorded operation history;
2. the WGL linearizability checker rejects at least one seed — with no
   model-specific probe involved (the online invariant latches all stay
   quiet on this bug, which is the point);
3. triage fingerprints the failure under the ``history`` flavor;
4. the shrinker ddmin-reduces the fault schedule to a minimal
   ``(FixedFaults, seed)`` the checker still rejects (every candidate
   re-verified through the checker, not the probe);
5. the sweep-extracted history bytes for that seed equal the bit-exact
   ``run_traced`` replay's — the cross-path determinism contract;
6. the matching clean config checks linearizable across the whole pinned
   range (no false positives).

Usage, from the repository root:
    python -m madsim_tpu_torch.scripts.oracle_demo [--seeds N] [--shrink-tests N] [--device D]

Exit code 0 iff all six hold.
"""

from __future__ import annotations

import argparse
import sys
import time

from . import _cli


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="oracle_demo")
    ap.add_argument("--seeds", type=int, default=32, help="pinned sweep size")
    ap.add_argument("--shrink-tests", type=int, default=8)
    _cli.add_device(ap)
    args = ap.parse_args(argv)
    dev = _cli.device(args, ap.prog)

    import numpy as np

    from .. import explore
    from ..engine import core as ecore
    from ..explore.targets import oracle_demo_faults
    from ..oracle import check_history, decode_seed, decode_sweep, history_bytes
    from ..replay import _host

    t0 = time.time()
    spec = oracle_demo_faults()
    seeds = np.arange(args.seeds, dtype=np.int64)

    # 1-2. find: the checker rejects seeds of the seeded-bug sweep
    target = explore.stale_etcd_target()
    workload, ecfg = target.build(spec)
    final = ecore.run_sweep(workload, ecfg, seeds, device=dev)
    vio = np.asarray(target.violating(final))
    print(f"[{time.time()-t0:5.1f}s] bug sweep: {vio.size}/{args.seeds} "
          f"seeds non-linearizable {[int(x) for x in vio[:8]]}")
    if vio.size == 0:
        print("FAIL: checker never fired on the seeded bug", file=sys.stderr)
        return 1
    online = int(_host(final.wstate.violation).sum())
    if online:
        print("FAIL: online latches saw the stale-read bug — the demo's "
              "premise (probe-invisible defect) broke", file=sys.stderr)
        return 1
    seed = int(vio[0])

    # 3. triage: the history fingerprint flavor
    failure = explore.triage_seed(target, spec, seed, history=True, device=dev)
    if failure is None or ":history:" not in failure.fingerprint:
        print(f"FAIL: triage lost the failure ({failure})", file=sys.stderr)
        return 1
    print(f"[{time.time()-t0:5.1f}s] triage: seed {seed} -> "
          f"{failure.fingerprint} (op #{failure.step})")

    # 4. shrink: minimal FixedFaults, every candidate checker-verified
    sr = explore.shrink(
        target, spec, seed, max_tests=args.shrink_tests, history=True, device=dev
    )
    if sr is None or sr.fingerprint != failure.fingerprint:
        print(f"FAIL: shrink lost the fingerprint ({sr})", file=sys.stderr)
        return 1
    again = explore.triage_seed(target, sr.spec, sr.seed, history=True, device=dev)
    if again is None or again.fingerprint != failure.fingerprint:
        print("FAIL: minimal triple does not reproduce", file=sys.stderr)
        return 1
    print(f"[{time.time()-t0:5.1f}s] shrink: {sr.original_len} -> "
          f"{len(sr.schedule)} fault events ({sr.tests} replays)")

    # 5. cross-path byte identity: sweep lane vs traced replay
    lane = int(np.nonzero(_host(final.seed) == seed)[0][0])
    sweep_bytes = history_bytes(decode_seed(final, lane))
    traced_final, _ = ecore.run_traced(workload, ecfg, seed, device=dev)
    traced_bytes = history_bytes(decode_seed(traced_final))
    if sweep_bytes != traced_bytes:
        print("FAIL: sweep-extracted history != traced-replay history",
              file=sys.stderr)
        return 1
    print(f"[{time.time()-t0:5.1f}s] byte identity: sweep lane == traced "
          f"replay ({len(sweep_bytes)} bytes)")

    # 6. clean control: no false positives over the same pinned range
    clean = explore.stale_etcd_target(bug_stale_read=False)
    cw, ce = clean.build(spec)
    cfinal = ecore.run_sweep(cw, ce, seeds, device=dev)
    bad = []
    for h in decode_sweep(cfinal):
        r = check_history(h, clean.hist_spec)
        if not r.ok:
            bad.append((h.seed, r.reason))
    if bad:
        print(f"FAIL: clean config flagged {bad[:3]}", file=sys.stderr)
        return 1
    print(f"[{time.time()-t0:5.1f}s] clean sweep: all {args.seeds} seeds "
          "linearizable")
    print("oracle demo: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
