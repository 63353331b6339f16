"""The fleet orchestrator: leased candidate batches over a shared store
(counterpart of ``madsim_tpu/explore/orchestrator.py``).

Ties the three fleet pieces together:

- **work plan**: the campaign's candidate stream is cut into *units* of
  ``CampaignConfig.batch`` candidates each, generated unit-locally —
  ``plan_unit(base, ccfg, u)`` seeds its own ``random.Random`` from
  ``(campaign_seed, u)`` and chains mutations inside the unit only, so
  ANY worker can regenerate ANY unit's candidates bit-identically with
  no cross-unit state (candidates draw from the base spec, not from a
  live corpus: adaptive parent selection would make the plan depend on
  completion order and break partition invariance).
- **leased execution**: a worker leases units from the shared
  :class:`~.store.CorpusStore` and feeds each leased unit's
  ``(candidate x seed)`` grid into ONE running ``stream_sweep`` through
  its ``feed=`` hook — the unit's lanes enter the pool mid-flight.
  Leases heartbeat on every chunk flush; a worker killed mid-unit stops
  renewing, its lease expires, and any peer reclaims and re-runs the
  unit — to identical record bytes, which the store's min-combine merge
  absorbs. Which unit a worker leases depends on timing; only the merged
  report is partition-invariant.
- **triage/shrink per unit**: when a unit's candidate summaries land,
  its violating seeds triage through the spec-as-data channel, and the
  FIRST instance of each fingerprint *within the unit* shrinks to a
  minimal ``FixedFaults`` schedule. Deliberately unit-pure: a worker
  never skips a shrink because the store already holds the fingerprint
  — that would make the merged bytes depend on work partitioning.
- **regression gate**: every stored bug's ``(FixedFaults, seed)``
  replays through :func:`regression_gate` — same fingerprint, same
  canonical-history sha. A found bug can never be silently un-found.

The merged report (:func:`merged_report`) is computed from the merged
store view in unit-key order — a pure function of the union of records,
byte-identical across 1 vs N workers, across kill-and-reclaim runs, and
to the reference's for the same plan. Every sweep and replay runs on
``device`` (None means CUDA).
"""

from __future__ import annotations

import hashlib
import json
import random
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import resolve_device
from ..engine.faults import (
    FaultEnvelope,
    grid_params,
    spec_to_params,
    tile_params,
)
from .campaign import (
    CampaignConfig,
    mutate_spec,
    spec_from_dict,
    spec_to_dict,
    target_envelope,
)
from .shrink import shrink
from .store import KIND_BUG, KIND_CAND, CorpusStore
from .targets import Target
from .triage import triage_seed


def plan_unit(base_spec, ccfg: CampaignConfig, unit: int) -> List[object]:
    """Unit ``unit``'s candidates: ``ccfg.batch`` specs chained by
    mutation from ``base_spec`` under a unit-local rng — any process
    regenerates any unit identically, independent of every other unit.
    Unit 0 leads with the unmutated base (the campaign's round 0).

    This is the UNIFORM plan. With ``ccfg.scheduler="bandit"`` the
    worker loop plans through ``steer.plan_unit_steered`` instead: the
    unit's candidates come from a bandit primed with the merged store's
    per-family stats over COMPLETED planning generations (leasing is
    generation-gated below), so the plan stays a pure function any
    worker computes identically — adaptive, without giving up the
    partition invariance this function's unit-locality buys."""
    rng = random.Random(f"fleet:{ccfg.campaign_seed}:{unit}")
    k = max(1, ccfg.batch)
    specs: List[object] = []
    cur = base_spec
    for j in range(k):
        if unit == 0 and j == 0:
            specs.append(base_spec)
            continue
        cur = mutate_spec(cur, rng, ccfg.mutations_hi)
        specs.append(cur)
    return specs


def _pow2_env(n_events: int) -> FaultEnvelope:
    """The fixed-schedule replay envelope for an ``n_events`` schedule —
    the same width rule as the shrinker, so gate replays share its
    compiled traced program."""
    width = 4
    while width < n_events:
        width *= 2
    return FaultEnvelope(fixed=width)


def _history_sha(target: Target, fixed, seed: int, device=None) -> Optional[str]:
    """sha256 of the minimal repro's canonical history (seed-free,
    time-rank canonical — oracle/history.py), through the spec-as-data
    one-lane sweep on ``device`` (None means CUDA). None when the target
    records no history."""
    import torch

    from ..engine import core as ecore
    from ..oracle import decode_seed
    from ..oracle.history import history_canonical_bytes

    env = _pow2_env(len(fixed.events))
    workload, ecfg = target.build(env)
    if target.hist_spec is None or workload.hist_slots == 0:
        return None
    dev = resolve_device(device)
    final = ecore.run_sweep(
        workload, ecfg, torch.tensor([seed], dtype=torch.int64, device=dev),
        params=tile_params(spec_to_params(fixed, env, target.num_nodes), 1),
        device=dev,
    )
    return hashlib.sha256(
        history_canonical_bytes(decode_seed(final, 0))
    ).hexdigest()


def run_worker(
    target: Target,
    base_spec,
    ccfg: CampaignConfig,
    store: CorpusStore,
    units: int,
    *,
    history: bool = False,
    shrink_tests: int = 48,
    max_units: Optional[int] = None,
    skip_gate: bool = False,
    telemetry=None,
    steer_cfg=None,
    _crash_after_units: Optional[int] = None,
    device=None,
) -> dict:
    """One fleet worker: lease units, stream them, triage+shrink, store.

    Runs the regression gate first (every stored bug must still replay
    — ``skip_gate`` only for drills), then opens ONE ``stream_sweep``
    whose ``feed`` leases the next available unit whenever lanes run
    dry. Returns ``{"units": [...], "fingerprints": sorted [...],
    "gate": ...}`` for this worker's own share; the authoritative
    cross-worker result is :func:`merged_report` over the store.

    ``max_units`` caps how many units THIS worker leases (the smoke's
    solo-vs-fleet comparison); ``_crash_after_units`` is the crash
    drill: after storing that many units the process dies by
    ``os._exit`` mid-append, leaving a torn record and an unrenewed
    lease behind for a peer to quarantine/reclaim.

    ``ccfg.scheduler="bandit"`` turns on steered planning: units group
    into generations of ``steer_cfg.gen_units``, a unit only becomes
    leasable once every unit of all earlier generations is DONE, and its
    candidates come
    from ``steer.plan_unit_steered`` primed with the merged per-family
    stats of those completed generations — identical stats on any
    worker, so the adaptive plan keeps the fleet's partition
    invariance. A worker that finds the current generation fully
    leased elsewhere drains its own in-flight units first, then
    sleep-polls for the barrier (peer crashes resolve through the
    normal lease-expiry reclaim). Steered candidate records additionally
    carry their ``family`` key, which is what the stats fold reads.

    The stream, the triage and shrink replays and the gate run on
    ``device`` (None means CUDA).
    """
    from ..engine.stream import stream_sweep

    dev = resolve_device(device)
    steered = ccfg.scheduler == "bandit"
    if steered:
        from .steer import SteerConfig, family_key, fold_family_stats, \
            plan_unit_steered

        scfg = steer_cfg if steer_cfg is not None else SteerConfig()

    gate = None
    if not skip_gate:
        gate = regression_gate(store, target, history=history, device=dev)
        if not gate["ok"]:
            raise AssertionError(
                f"regression gate failed before work started: "
                f"{gate['mismatches']}"
            )

    envelope = target_envelope(target, base_spec)
    workload, ecfg = target.build(envelope)
    s = ccfg.seeds_per_round
    k = max(1, ccfg.batch)
    seed_range = np.arange(ccfg.seed0, ccfg.seed0 + s, dtype=np.int64)

    # mirrors sweep_candidate_grid: device screen per retirement cohort,
    # WGL checker over the suspects in the overlapped host phase
    screen_fn = None
    if target.hist_spec is not None:
        from ..oracle.screen import screen_for, screen_sweep

        if screen_for(target.hist_spec) is not None:
            def screen_fn(final):
                return screen_sweep(final, target.hist_spec)

    def host_work(final, *, lo, n, seeds, suspect, summary) -> dict:
        del lo, n, seeds
        cstats: dict = {}
        if suspect is not None:
            from ..oracle.check import violating_seeds

            vio = violating_seeds(
                final, target.hist_spec, screen=lambda _f: suspect,
                workers=ccfg.check_workers, stats=cstats,
            )
        else:
            vio = np.asarray(target.violating(final))
        out = {
            "violating_seeds": [int(x) for x in vio[: ccfg.max_recorded_seeds]]
        }
        if "violations" not in summary:
            out["violations"] = int(vio.size)
        # honest-verdict bookkeeping: lanes whose WGL search ran out of
        # state budget count as non-violating above, so the unit summary
        # carries the count (merge_summaries sums it across chunks)
        if cstats.get("budget_exceeded"):
            out["budget_exceeded"] = int(cstats["budget_exceeded"])
            if telemetry is not None:
                telemetry.count(
                    "oracle_budget_exceeded_total",
                    int(cstats["budget_exceeded"]),
                    help="WGL verdicts undecided at max_states",
                )
        return out

    fed: List[Tuple[int, List[object]]] = []  # feed order: (unit, specs)
    leases: Dict[int, object] = {}  # unit -> live Lease
    pending: Dict[int, List[Optional[dict]]] = {}  # unit -> K summaries
    unit_fams: Dict[int, List[int]] = {}  # steered: unit -> family masks
    my_units: List[int] = []
    my_fps: set = set()
    stored = 0  # units finalized by THIS worker (crash-drill counter)

    def heartbeat():
        for unit, lease in list(leases.items()):
            if not store.renew(lease):
                # reclaimed out from under us (we looked dead): the unit
                # is no longer ours to mark, but finishing the compute
                # and appending its records stays harmless — identical
                # bytes, min-combined at merge
                del leases[unit]
        if telemetry is not None and leases:
            telemetry.gauge(
                "fleet_leases_held", len(leases),
                help="units currently leased by this worker",
            )

    def _steer_limit() -> int:
        """The generation barrier: units are leasable only up to the
        end of the first generation containing a not-done unit, so the
        stats a later unit's plan consults are frozen before any worker
        can lease it."""
        g = max(1, scfg.gen_units)
        first_open = units
        for u in range(units):
            if not store.is_done(u):
                first_open = u
                break
        return min(units, (first_open // g + 1) * g)

    def _steer_stats(unit: int) -> dict:
        """Per-family stats over the COMPLETED generations below
        ``unit`` — a pure function of their (immutable, min-combined)
        records, identical on every worker by the generation barrier."""
        cutoff = (unit // max(1, scfg.gen_units)) * max(1, scfg.gen_units)
        if cutoff == 0:
            return {}
        merged = store.merged()
        return fold_family_stats(
            [
                (key, p)
                for (kind, key), p in merged.items()
                if kind == KIND_CAND and int(p["unit"]) < cutoff
            ],
            [
                (key, p)
                for (kind, key), p in merged.items()
                if kind == KIND_BUG and int(p["unit"]) < cutoff
            ],
        )

    def acquire() -> Optional[dict]:
        """Lease the next unit and build its feed segment."""
        if max_units is not None and len(my_units) >= max_units:
            return None
        while True:
            limit = _steer_limit() if steered else units
            lease = store.next_lease(limit)
            if lease is None:
                if steered and limit < units:
                    # the open generation is leased elsewhere and later
                    # units are barrier-gated: drain our own in-flight
                    # units first (their finalize may complete the
                    # generation), else wait for peers / lease expiry
                    if pending:
                        return None
                    if store.all_done(units):
                        return None
                    if telemetry is not None:
                        telemetry.count(
                            "steer_gen_waits_total",
                            help="generation-barrier waits while peers "
                            "finish the open generation",
                        )
                    time.sleep(0.05)
                    heartbeat()
                    continue
                return None
            if lease.unit in pending:
                # our own expired lease came back through the reclaim
                # path: re-hold it, don't feed the unit a second time
                leases[lease.unit] = lease
                continue
            break
        if steered:
            planned = plan_unit_steered(
                base_spec, ccfg, scfg, lease.unit, _steer_stats(lease.unit)
            )
            unit_fams[lease.unit] = [m for m, _ in planned]
            specs = [sp for _, sp in planned]
        else:
            specs = plan_unit(base_spec, ccfg, lease.unit)
        fed.append((lease.unit, specs))
        leases[lease.unit] = lease
        pending[lease.unit] = [None] * k
        my_units.append(lease.unit)
        if telemetry is not None:
            telemetry.event("fleet_lease", unit=lease.unit)
        return {
            "seeds": np.tile(seed_range, k),
            "params": grid_params(
                [
                    spec_to_params(sp, envelope, target.num_nodes)
                    for sp in specs
                ],
                s,
            ),
        }

    def finalize(unit: int, specs: List[object]) -> None:
        """All K summaries for ``unit`` landed: store its candidate
        records and its bugs (first instance per fingerprint WITHIN the
        unit, triaged + shrunk), then retire the lease. A pure function
        of the unit — store content never influences what gets written
        (partition invariance)."""
        nonlocal stored
        summaries = pending.pop(unit)
        fams = unit_fams.pop(unit, None)
        unit_fps: Dict[str, Tuple[int, object, int]] = {}
        for ci, (spec, summary) in enumerate(zip(specs, summaries)):
            vio = summary.get("violating_seeds", [])
            payload = {
                "unit": unit,
                "cand": ci,
                "spec": spec_to_dict(spec),
                "violations": int(summary["violations"]),
                "violating_seeds": [int(x) for x in vio],
                "coverage_map": [
                    int(w) for w in summary.get("coverage_map", [])
                ],
                "events_total": int(summary.get("events_total", 0)),
            }
            if fams is not None:
                # the steered plan's family attribution — what
                # fold_family_stats reads back; uniform payloads stay
                # byte-identical to the pre-steering format
                payload["family"] = family_key(fams[ci])
            store.append(KIND_CAND, f"{unit:06d}/{ci:02d}", payload)
            for seed in vio:
                f = triage_seed(
                    target, envelope, int(seed), history=history,
                    params=spec_to_params(spec, envelope, target.num_nodes),
                    device=dev,
                )
                if f is not None and f.fingerprint not in unit_fps:
                    unit_fps[f.fingerprint] = (ci, spec, int(seed))
        for fp in sorted(unit_fps):
            ci, spec, seed = unit_fps[fp]
            sr = shrink(
                target, spec, seed, max_tests=shrink_tests, history=history,
                device=dev,
            )
            payload = {
                "fingerprint": fp,
                "unit": unit,
                "cand": ci,
                "seed": seed,
                "spec": spec_to_dict(spec),
                "fixed": None if sr is None else spec_to_dict(sr.spec),
                "schedule": None
                if sr is None
                else [[t, a, v] for t, a, v in sr.schedule],
                "original_len": None if sr is None else sr.original_len,
                "history_sha": None
                if sr is None
                else _history_sha(target, sr.spec, seed, device=dev),
            }
            store.append(KIND_BUG, fp, payload)
            my_fps.add(fp)
        stored += 1
        if _crash_after_units is not None and stored >= _crash_after_units:
            # the kill -9 drill: die mid-append — a torn half-record on
            # our log, done marker never written, lease left to expire
            import os as _os

            if store._log_f is None:
                store._log_f = open(store._log_path, "a")
            store._log_f.write('{"kind": "bug", "key": "torn-')
            store._log_f.flush()
            _os.fsync(store._log_f.fileno())
            _os._exit(137)
        store.mark_done(unit)
        lease = leases.pop(unit, None)
        if lease is not None:
            store.release(lease)
        if telemetry is not None:
            telemetry.count("fleet_units_done_total", help="units finalized")
            telemetry.event(
                "fleet_unit_done", unit=unit,
                fingerprints=sorted(unit_fps),
            )

    def on_chunk(*, lo, k: int, summary):  # noqa: ANN001 - stream contract
        heartbeat()
        c = lo // s
        unit, specs = fed[c // max(1, ccfg.batch)]
        pending[unit][c % max(1, ccfg.batch)] = summary
        if all(x is not None for x in pending[unit]):
            finalize(unit, specs)

    def feed() -> Optional[dict]:
        heartbeat()
        return acquire()

    first = acquire()
    if first is not None:
        stream_sweep(
            workload, ecfg, first["seeds"], target.summarize,
            params=first["params"], chunk_size=s,
            pool_size=max(ccfg.chunk_size, s),
            host_work=host_work, screen=screen_fn,
            on_chunk=on_chunk, feed=feed, telemetry=telemetry,
            device=dev,
        )
    store.close()
    return {
        "worker": store.worker,
        "units": my_units,
        "fingerprints": sorted(my_fps),
        "gate": gate,
    }


def merged_report(store: CorpusStore) -> str:
    """The byte-deterministic fleet report: one JSONL string computed
    from the merged store view in unit-key order — coverage accounting
    (new_bits / retained / coverage_total_bits) folds at MERGE time, so
    the bytes are identical for any worker count, any lease schedule,
    and any kill-and-reclaim history over the same plan."""
    merged = store.merged()
    cands = sorted(
        (key, p) for (kind, key), p in merged.items() if kind == KIND_CAND
    )
    bugs = sorted(
        (key, p) for (kind, key), p in merged.items() if kind == KIND_BUG
    )
    lines = [
        json.dumps(
            {
                "kind": "fleet_header",
                "cands": len(cands),
                "bugs": len(bugs),
            },
            sort_keys=True,
        )
    ]
    global_map: List[int] = []
    for key, p in cands:
        cand_map = [int(w) for w in p.get("coverage_map", [])]
        if len(global_map) < len(cand_map):
            global_map += [0] * (len(cand_map) - len(global_map))
        new_bits = sum(
            (c & ~g).bit_count() for c, g in zip(cand_map, global_map)
        )
        retained = (key == "000000/00") or new_bits > 0
        if retained:
            global_map = [g | c for g, c in zip(global_map, cand_map)]
        rec = {k: v for k, v in p.items() if k != "coverage_map"}
        rec.update(
            kind="cand",
            key=key,
            new_bits=new_bits,
            retained=retained,
            coverage_total_bits=sum(w.bit_count() for w in global_map),
        )
        lines.append(json.dumps(rec, sort_keys=True))
    for key, p in bugs:
        lines.append(
            json.dumps({**p, "kind": "bug", "key": key}, sort_keys=True)
        )
    return "\n".join(lines) + "\n"


def write_merged(store: CorpusStore, path: str) -> None:
    with open(path, "w") as f:
        f.write(merged_report(store))


def regression_gate(
    store: CorpusStore, target: Target, *, history: bool = False, device=None
) -> dict:
    """Replay every stored bug's minimal ``(FixedFaults, seed)`` triple
    bit-exactly on ``device`` (None means CUDA): the triage fingerprint
    must match the stored one, and the canonical-history sha (when
    recorded) must recompute identically. Returns ``{"checked",
    "skipped", "ok", "mismatches"}`` — a mismatch means a previously
    found bug would now be silently un-found, which is exactly what the
    gate exists to catch."""
    dev = resolve_device(device)
    merged = store.merged()
    bugs = sorted(
        (key, p) for (kind, key), p in merged.items() if kind == KIND_BUG
    )
    checked = skipped = 0
    mismatches: List[dict] = []
    for key, p in bugs:
        if p.get("fixed") is None:
            skipped += 1  # shrink failed at store time; nothing replayable
            continue
        fixed = spec_from_dict(p["fixed"])
        seed = int(p["seed"])
        env = _pow2_env(len(fixed.events))
        f = triage_seed(
            target, env, seed, history=history,
            params=spec_to_params(fixed, env, target.num_nodes),
            device=dev,
        )
        checked += 1
        if f is None or f.fingerprint != p["fingerprint"]:
            mismatches.append(
                {
                    "fingerprint": p["fingerprint"],
                    "seed": seed,
                    "got": None if f is None else f.fingerprint,
                    "why": "no longer violates" if f is None
                    else "fingerprint changed",
                }
            )
            continue
        want_sha = p.get("history_sha")
        if want_sha is not None:
            got_sha = _history_sha(target, fixed, seed, device=dev)
            if got_sha != want_sha:
                mismatches.append(
                    {
                        "fingerprint": p["fingerprint"],
                        "seed": seed,
                        "got": got_sha,
                        "why": "canonical history diverged",
                    }
                )
    return {
        "checked": checked,
        "skipped": skipped,
        "ok": not mismatches,
        "mismatches": mismatches,
    }
