"""The self-steering scheduler: coverage-guided compute allocation
(counterpart of ``madsim_tpu/explore/steer.py``).

The fleet *reallocates its own compute* toward the envelope regions
still producing novel failures, as a pure queue policy over
``stream_sweep``'s ``feed=`` hook: the lane pool never drains, and
candidates ride in as spec-as-data ``FaultParams`` rows.

The pieces:

- **Families** partition the campaign envelope: a family is the bitmask
  of active fault-category count fields (``campaign._COUNT_FIELDS`` —
  crashes, partitions, ..., skews), and a candidate is a point of that
  region reached by a *mutation lineage* — a seeded mutation chain
  confined to the family's mask. ``family_candidate(base, mask, seed,
  lineage)`` regenerates any chain element bit-identically anywhere
  (the rng key derives from the campaign seed through ``rand.mix64``, the
  splitmix64 finalizer — one seed, one chain).
- **The bandit** (:class:`BanditScheduler`) is UCB1 over families,
  scored by novel-coverage-bits-per-device-event. The argmax needs no
  sampling key, so every decision is a pure function of the absorbed
  outcomes plus the campaign seed. "Device-seconds" are the
  deterministic proxy ``events_total`` (wall clocks never influence a
  decision); a fresh triage fingerprint is worth ``fp_bits`` coverage
  bits so the bandit mines violation-bearing regions, not just the
  coverage frontier.
- **Early-kill**: a family whose fingerprint-dedup hit rate saturates
  (``kill_dup_rate_pct``) or that stays barren (no new bits, no fresh
  fingerprints) for ``kill_plays`` consecutive plays is removed from
  the universe — its remaining budget flows to live families. The last
  live family is never killed.
- **Escalation**: a family's first violation marks it hot — later
  candidates get ``escalate_seeds`` x the seeds and the long step
  budget (``budget_hi_steps``), through the stream's per-lane
  ``budgets=``.

Determinism contract: every decision is a pure function of (campaign
seed, config, absorbed outcome prefix). Outcomes absorb strictly in
submission order (the stream flushes virtual chunks in submission order
whatever its round and refill schedule — the port's stream reads its
quorum every 16 steps, so its schedule is not the reference's, and no
byte depends on it), and decision ``i`` sees exactly the outcomes of
candidates ``0..i-1-pipeline``. So a replayed campaign makes the same
decisions and writes the same report and decision-trace bytes as the
reference. The trace carries no wall times; scores are recorded as
integer micros. The same records mirror out of band into a telemetry
journal as ``steer_round`` events.

``run_steered`` is the whole loop; ``CampaignConfig.scheduler="bandit"``
routes ``explore.run_campaign`` here, and ``scheduler="uniform"`` in a
:class:`SteerConfig` turns the identical loop into the matched
round-robin grid. Every sweep and triage replay runs on ``device``
(None means CUDA), or on ``mesh``'s ranks.
"""

from __future__ import annotations

import json
import math
import random
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..rand import mix64
from .campaign import (
    _COUNT_FIELDS,
    CampaignConfig,
    CampaignResult,
    mutate_spec,
    spec_to_dict,
    target_envelope,
)
from .targets import Target

_M64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# family keying


def family_of(spec) -> int:
    """The family bitmask of a ``FaultSpec``: bit ``i`` set iff count
    field ``_COUNT_FIELDS[i]`` is active (> 0). Pure structure — two
    specs differing only in windows/durations/rates share a family."""
    mask = 0
    for i, f in enumerate(_COUNT_FIELDS):
        if getattr(spec, f) > 0:
            mask |= 1 << i
    return mask


def family_key(mask: int) -> str:
    """The stable 3-hex-digit record key of a family bitmask (9
    category bits fit 0x000..0x1ff; fixed width keeps keys sortable)."""
    return f"{mask:03x}"


def family_universe(base_spec) -> Tuple[int, ...]:
    """The default family universe for a base spec: the base's own
    family, every single-category family, and the base joined with each
    other category — sorted, deduped. Single-category duds are the
    point: a uniform grid pays for them forever, the bandit kills them."""
    base = family_of(base_spec)
    masks = {1 << i for i in range(len(_COUNT_FIELDS))}
    if base:
        masks.add(base)
        masks.update(base | (1 << i) for i in range(len(_COUNT_FIELDS)))
    return tuple(sorted(masks))


def _mask_spec(spec, mask: int):
    """Confine ``spec`` to family ``mask``: off-mask count fields drop
    to 0, on-mask fields rise to at least 1 (a family member exercises
    every category its mask names)."""
    updates = {}
    for i, f in enumerate(_COUNT_FIELDS):
        v = getattr(spec, f)
        if not mask & (1 << i):
            if v:
                updates[f] = 0
        elif v == 0:
            updates[f] = 1
    return spec._replace(**updates) if updates else spec


def _chain_rng(campaign_seed: int, mask: int, salt: int) -> random.Random:
    """The mutation-chain rng for one ``(family, salt)`` lineage —
    derived from the campaign seed through ``rand.mix64`` (the splitmix64
    finalizer), so family chains are independent streams of ONE
    explicitly seeded key."""
    k = mix64(campaign_seed & _M64)
    k = mix64(k ^ mask)
    k = mix64(k ^ (salt & _M64))
    return random.Random(k)


def family_candidate(
    base_spec,
    mask: int,
    campaign_seed: int,
    lineage: int,
    mutations_hi: int = 2,
    salt: int = 0,
):
    """Candidate ``lineage`` of family ``mask``'s mutation chain: the
    masked base for lineage 0, then seeded ``mutate_spec`` rounds
    re-confined to the mask — a pure function of ``(base, mask,
    campaign_seed, lineage, salt)``, regenerable bit-identically by any
    process. ``salt`` namespaces independent chains (e.g. per fleet
    unit); a salted chain starts one mutation deep, so two units of one
    generation that pick the same ``(family, lineage)`` still sweep
    DISTINCT candidates (lineage 0 of the unsalted chain is the masked
    base itself — the bland starting point a solo campaign wants)."""
    rng = _chain_rng(campaign_seed, mask, salt)
    cur = _mask_spec(base_spec, mask)
    for _ in range(lineage + (1 if salt else 0)):
        # a draw whose mutations all hit off-mask fields no-ops after
        # re-masking; retry (bounded, deterministic) so chain elements
        # actually move even under single-category masks
        for _try in range(8):
            nxt = _mask_spec(mutate_spec(cur, rng, mutations_hi), mask)
            if nxt != cur:
                break
        cur = nxt
    return cur


# ---------------------------------------------------------------------------
# the bandit


class SteerConfig(NamedTuple):
    """Static scheduler parameters (hashable; the report header records
    them, so compare steered reports only across runs of one config).

    All knobs are integers on purpose — the config travels through
    JSON report headers and the determinism gates byte-diff those."""

    scheduler: str = "bandit"  # "bandit" | "uniform" (the A/B switch)
    families: Tuple[int, ...] = ()  # () = family_universe(base_spec)
    ucb_c_milli: int = 1400  # exploration constant x 1e-3
    fp_bits: int = 64  # coverage-bit value of one fresh fingerprint
    kill_plays: int = 3  # plays before a family may be killed
    kill_dup_rate_pct: int = 90  # dedup-hit-rate saturation threshold
    escalate_seeds: int = 2  # seeds multiplier for hot families
    budget_lo_steps: int = 0  # per-lane step budget (0 = cfg.max_steps)
    budget_hi_steps: int = 0  # escalated budget (0 = cfg.max_steps)
    pipeline: int = 2  # decisions in flight ahead of their outcomes
    budget_events: int = 0  # total device-event budget (0 = rounds-capped)
    gen_units: int = 2  # fleet: units per planning generation


def _stats0() -> dict:
    return {
        "plays": 0,  # absorbed outcomes
        "events": 0,  # deterministic device-second proxy spent
        "new_bits": 0,  # novel coverage bits earned
        "vio": 0,  # violating seeds observed (recorded sample)
        "fresh": 0,  # first-seen triage fingerprints
        "dup": 0,  # recorded violating seeds with a known fingerprint
        "barren": 0,  # consecutive plays with no new bits, no fresh fps
    }


class BanditScheduler:
    """Deterministic UCB1 compute allocator over candidate families.

    ``decide()`` emits the next decision record; ``absorb()`` folds one
    outcome (in submission order) and applies the kill/escalate
    transitions. Every record appended to ``trace`` is deterministic
    bytes — no wall times, scores as integer micros. ``scheduler=
    "uniform"`` degrades the same object to the matched round-robin
    grid (no kills, no escalation, fixed seeds/budget) so the A/B
    differs in POLICY only."""

    def __init__(
        self,
        universe: Sequence[int],
        scfg: SteerConfig,
        *,
        seeds_per_play: int,
        budget_lo: int,
        budget_hi: int,
    ):
        if not universe:
            raise ValueError("family universe is empty")
        if scfg.scheduler not in ("bandit", "uniform"):
            raise ValueError(f"unknown scheduler {scfg.scheduler!r}")
        self.universe: Tuple[int, ...] = tuple(universe)
        self.scfg = scfg
        self.seeds_per_play = int(seeds_per_play)
        self.budget_lo = int(budget_lo)
        self.budget_hi = int(budget_hi)
        self.stats: Dict[int, dict] = {m: _stats0() for m in self.universe}
        self.decided: Dict[int, int] = {m: 0 for m in self.universe}
        self.killed: Dict[int, str] = {}  # mask -> reason
        self.escalated: List[int] = []
        self.trace: List[dict] = []
        self.t = 0  # decisions emitted
        self.absorbed = 0  # outcomes folded
        self.spent_events = 0

    # -- scoring ----------------------------------------------------------

    def alive(self) -> List[int]:
        return [m for m in self.universe if m not in self.killed]

    def _reward(self, st: dict) -> float:
        """Novel coverage bits (fresh fingerprints count ``fp_bits``
        each) per device event — the deterministic bits-per-device-
        second signal."""
        value = st["new_bits"] + self.scfg.fp_bits * st["fresh"]
        return value / max(st["events"], 1)

    def _score(self, mask: int, total_plays: int, r_bar: float) -> float:
        st = self.stats[mask]
        # in-flight decisions count toward the arm's pull count, so the
        # pipelined loop spreads cold exploration instead of double-
        # committing to one family before its first outcome lands
        n = max(self.decided[mask], 1)
        c = self.scfg.ucb_c_milli / 1000.0
        bonus = c * max(r_bar, 1e-12) * math.sqrt(
            math.log(max(total_plays, 2)) / max(n, 1)
        )
        return self._reward(st) + bonus

    def _pick(self) -> Tuple[int, str]:
        alive = self.alive()
        if self.scfg.scheduler == "uniform":
            return alive[self.t % len(alive)], "uniform"
        cold = [m for m in alive if self.decided[m] == 0]
        if cold:
            return cold[0], "cold"
        total_plays = sum(self.decided[m] for m in alive)
        tot = _stats0()
        for m in alive:
            st = self.stats[m]
            tot["events"] += st["events"]
            tot["new_bits"] += st["new_bits"]
            tot["fresh"] += st["fresh"]
        r_bar = self._reward(tot)
        # max score, ties broken by fewest decisions then mask order —
        # a total order, so the argmax is deterministic
        best = min(
            alive,
            key=lambda m: (-self._score(m, total_plays, r_bar),
                           self.decided[m], m),
        )
        return best, "ucb"

    # -- the two verbs ----------------------------------------------------

    def decide(self) -> dict:
        """Emit decision ``t``: which family to sweep next, with how
        many seeds and what per-lane step budget. Pure function of the
        absorbed outcome prefix + config."""
        mask, why = self._pick()
        hot = mask in self.escalated
        seeds = self.seeds_per_play * (
            self.scfg.escalate_seeds if hot else 1
        )
        st = self.stats[mask]
        total_plays = sum(self.decided[m] for m in self.alive())
        tot = _stats0()
        for m in self.alive():
            s2 = self.stats[m]
            tot["events"] += s2["events"]
            tot["new_bits"] += s2["new_bits"]
            tot["fresh"] += s2["fresh"]
        score = (
            0.0
            if why != "ucb"
            else self._score(mask, total_plays, self._reward(tot))
        )
        rec = {
            "kind": "decide",
            "i": self.t,
            "family": family_key(mask),
            "lineage": self.decided[mask],
            "why": why,
            "hot": hot,
            "seen": self.absorbed,
            "seeds": seeds,
            "budget": self.budget_hi if hot else self.budget_lo,
            "score_micro": int(round(score * 1e6)),
            "plays": st["plays"],
            "alive": len(self.alive()),
        }
        self.decided[mask] += 1
        self.t += 1
        self.trace.append(rec)
        return rec

    def absorb(self, mask: int, outcome: dict) -> dict:
        """Fold candidate outcome ``absorbed`` (submission order):
        ``{"events", "new_bits", "vio", "fresh", "dup"}`` — all
        byte-deterministic sweep products — then run the kill/escalate
        transitions. Returns the outcome trace record."""
        st = self.stats[mask]
        st["plays"] += 1
        st["events"] += int(outcome["events"])
        st["new_bits"] += int(outcome["new_bits"])
        st["vio"] += int(outcome["vio"])
        st["fresh"] += int(outcome["fresh"])
        st["dup"] += int(outcome["dup"])
        if outcome["new_bits"] or outcome["fresh"]:
            st["barren"] = 0
        else:
            st["barren"] += 1
        self.spent_events += int(outcome["events"])
        self.absorbed += 1
        rec = {
            "kind": "outcome",
            "i": self.absorbed - 1,
            "family": family_key(mask),
            "events": int(outcome["events"]),
            "new_bits": int(outcome["new_bits"]),
            "vio": int(outcome["vio"]),
            "fresh": int(outcome["fresh"]),
            "dup": int(outcome["dup"]),
            "spent_events": self.spent_events,
        }
        self.trace.append(rec)
        if self.scfg.scheduler == "uniform":
            return rec
        if mask not in self.escalated and st["vio"] > 0:
            # first violation: the family is near a bug — escalate its
            # horizon and seed allocation from the NEXT decision on
            self.escalated.append(mask)
            self.trace.append(
                {
                    "kind": "escalate",
                    "family": family_key(mask),
                    "at": self.absorbed - 1,
                }
            )
        self._maybe_kill(mask, st)
        return rec

    def _maybe_kill(self, mask: int, st: dict) -> None:
        if mask in self.killed or len(self.alive()) <= 1:
            return
        if st["plays"] < self.scfg.kill_plays:
            return
        reason = None
        recorded = st["fresh"] + st["dup"]
        if (
            recorded
            and st["barren"] >= 1
            and 100 * st["dup"] >= self.scfg.kill_dup_rate_pct * recorded
        ):
            reason = "dup-saturated"
        elif st["barren"] >= self.scfg.kill_plays:
            reason = "barren"
        if reason is not None:
            self.killed[mask] = reason
            self.trace.append(
                {
                    "kind": "kill",
                    "family": family_key(mask),
                    "why": reason,
                    "at": self.absorbed - 1,
                }
            )

    def trace_lines(self) -> str:
        """The decision trace as deterministic JSONL bytes (sorted
        keys, no wall times) — what the determinism gate byte-diffs and
        what mirrors into the journal as ``steer_round`` events."""
        return (
            "\n".join(json.dumps(r, sort_keys=True) for r in self.trace)
            + "\n"
        )


# ---------------------------------------------------------------------------
# per-family stats from stored fleet records (the orchestrator's view)


def fold_family_stats(
    cands: Sequence[Tuple[str, dict]],
    bugs: Sequence[Tuple[str, dict]],
) -> Dict[int, dict]:
    """Per-family stats from a merged store view — the pure function of
    the record set ``plan_unit_steered`` consults, so ANY worker
    computes identical stats from identical completed units.

    ``cands``/``bugs`` are ``(key, payload)`` pairs as ``merged()``
    yields them; the fold runs in sorted key order with the same
    coverage accounting as ``orchestrator.merged_report``, so the
    new-bits attribution is partition-invariant. Fingerprint dedup uses
    the bug records' ``(unit, cand)`` attribution: a fingerprint is
    fresh at its first fold-order appearance. Recorded violating seeds
    beyond the fresh count approximate the dup hits (per-seed
    fingerprints are not stored; the approximation is deterministic,
    which is what matters here)."""
    fps_at: Dict[Tuple[int, int], List[str]] = {}
    # sort by KEY alone: payloads are dicts (unorderable), and equal
    # keys would otherwise make the fold order compare them
    for _key, p in sorted(bugs, key=lambda kp: kp[0]):
        fps_at.setdefault((int(p["unit"]), int(p["cand"])), []).append(
            p["fingerprint"]
        )
    stats: Dict[int, dict] = {}
    seen_fps: set = set()
    global_map: List[int] = []
    for key, p in sorted(cands, key=lambda kp: kp[0]):
        fam = p.get("family")
        if fam is None:
            continue  # records from an unsteered plan carry no family
        mask = int(fam, 16)
        st = stats.setdefault(mask, _stats0())
        cand_map = [int(w) for w in p.get("coverage_map", [])]
        if len(global_map) < len(cand_map):
            global_map += [0] * (len(cand_map) - len(global_map))
        new_bits = sum(
            (c & ~g).bit_count() for c, g in zip(cand_map, global_map)
        )
        global_map = [g | c for g, c in zip(global_map, cand_map)]
        fresh = 0
        for fp in fps_at.get((int(p["unit"]), int(p["cand"])), []):
            if fp not in seen_fps:
                seen_fps.add(fp)
                fresh += 1
        recorded = len(p.get("violating_seeds", []))
        st["plays"] += 1
        st["events"] += int(p.get("events_total", 0))
        st["new_bits"] += new_bits
        st["vio"] += int(p.get("violations", 0))
        st["fresh"] += fresh
        st["dup"] += max(0, recorded - fresh)
        if new_bits or fresh:
            st["barren"] = 0
        else:
            st["barren"] += 1
    return stats


def plan_unit_steered(
    base_spec,
    ccfg: CampaignConfig,
    scfg: SteerConfig,
    unit: int,
    stats: Dict[int, dict],
) -> List[Tuple[int, object]]:
    """Unit ``unit``'s steered candidates: ``ccfg.batch`` ``(mask,
    spec)`` pairs chosen by a bandit primed with ``stats`` (the merged
    store's per-family view over COMPLETED generations — every worker
    that plans this unit holds the identical view, so the plan is
    partition-invariant like the uniform ``plan_unit``). Candidate
    lineages are salted by the unit, so distinct units of one
    generation explore distinct chain elements of the same families."""
    universe = scfg.families or family_universe(base_spec)
    sched = BanditScheduler(
        universe, scfg,
        seeds_per_play=ccfg.seeds_per_round,
        budget_lo=scfg.budget_lo_steps,
        budget_hi=scfg.budget_hi_steps,
    )
    for mask in universe:
        st = stats.get(mask)
        if st is None:
            continue
        sched.stats[mask] = dict(st)
        sched.decided[mask] = st["plays"]
        if st["vio"] > 0:
            sched.escalated.append(mask)
        sched._maybe_kill(mask, sched.stats[mask])
    sched.absorbed = sum(st["plays"] for st in stats.values())
    out: List[Tuple[int, object]] = []
    per_family: Dict[int, int] = {}
    for _j in range(max(1, ccfg.batch)):
        rec = sched.decide()
        mask = int(rec["family"], 16)
        lineage = per_family.get(mask, 0)
        per_family[mask] = lineage + 1
        out.append(
            (
                mask,
                family_candidate(
                    base_spec, mask, ccfg.campaign_seed, lineage,
                    ccfg.mutations_hi, salt=unit + 1,
                ),
            )
        )
    return out


def _jfields(rec: dict) -> dict:
    """A trace record as journal-event fields: the trace's ``kind``
    (decide/outcome) moves to ``step`` — the journal writer owns the
    ``kind`` key (it becomes ``steer_round``)."""
    out = dict(rec)
    out["step"] = out.pop("kind")
    return out


# ---------------------------------------------------------------------------
# the steered campaign loop


class SteerResult(NamedTuple):
    """``run_steered``'s product — a superset of ``CampaignResult``."""

    corpus: List[object]
    records: List[dict]
    failures: List[Tuple[object, int]]
    coverage_map: List[int]
    decisions: List[dict]  # the deterministic decision trace
    fingerprints: List[str]  # sorted distinct triage fingerprints
    spent_events: int

    def campaign_result(self) -> CampaignResult:
        return CampaignResult(
            corpus=self.corpus,
            records=self.records,
            failures=self.failures,
            coverage_map=self.coverage_map,
        )


def run_steered(
    target: Target,
    base_spec,
    ccfg: CampaignConfig = CampaignConfig(),
    scfg: Optional[SteerConfig] = None,
    *,
    history: bool = False,
    report_path: Optional[str] = None,
    trace_path: Optional[str] = None,
    mesh=None,
    telemetry=None,
    device=None,
) -> SteerResult:
    """The steered campaign: ONE ``stream_sweep`` whose ``feed=`` queue
    the bandit fills, decision by decision, until ``ccfg.rounds``
    decisions or ``scfg.budget_events`` device events are spent.

    Pipeline discipline (the determinism contract): ``scfg.pipeline``
    decisions are primed cold; afterwards exactly one new decision is
    made per absorbed outcome, inside the submission-order ``on_chunk``
    flush — so decision ``i`` sees outcomes ``0..i-1-pipeline`` no
    matter how lanes retire or refill, and a replay is bit-identical.
    The stream polls ``feed`` whenever lanes run dry: a decided segment
    is handed over if one is ready, else the pool drains, flushes (which
    decides more), and polls again — occupancy may dip, bytes may not.

    Escalated candidates feed ``escalate_seeds`` chunk-sized segments
    and the ``budget_hi_steps`` per-lane budget; an escalated family's
    undispatched items also jump the queue through the stream's
    ``reprioritize`` hook (a zero-recompile reorder — dispatch order
    changes, report bytes cannot, by the stream's submission-order
    flush contract).

    The stream and every triage replay run on ``device`` (None means
    CUDA); with ``mesh`` (a ``parallel.SeedMesh``; every rank calls with
    the same arguments) the pool is sharded over its ranks, each rank
    replays on its own device and makes the same decisions, and rank 0
    writes the files.

    Returns a :class:`SteerResult`; ``report_path`` writes the
    campaign-style JSONL report, ``trace_path`` the decision-trace
    JSONL — both deterministic bytes for one ``(ccfg, scfg)``."""
    import time as _time

    from .. import resolve_device
    from ..engine import tree
    from ..engine.faults import spec_to_params, tile_params
    from ..engine.stream import stream_sweep
    from ..models._common import coverage_bit_count, merge_summaries
    from .triage import triage_seed

    dev = resolve_device(device) if mesh is None else mesh.device
    if scfg is None:
        scfg = SteerConfig()
    envelope = target_envelope(target, base_spec)
    workload, ecfg = target.build(envelope)
    if workload.cover is None or workload.cover_bits == 0:
        raise ValueError(
            f"target {target.name!r} workload defines no coverage signal "
            "(Workload.cover/cover_bits); steering needs the reward"
        )
    # ``history=True`` routes triage through the history oracle (the
    # run_worker convention) — required for targets whose violations
    # only the WGL checker sees (etcd's stale reads latch nothing)
    hist_triage = history
    s0 = ccfg.seeds_per_round
    budget_lo = min(scfg.budget_lo_steps or ecfg.max_steps, ecfg.max_steps)
    budget_hi = min(scfg.budget_hi_steps or ecfg.max_steps, ecfg.max_steps)
    universe = scfg.families or family_universe(base_spec)
    sched = BanditScheduler(
        universe, scfg,
        seeds_per_play=s0, budget_lo=budget_lo, budget_hi=budget_hi,
    )
    t0_wall = _time.perf_counter()

    # mirrors sweep_candidate_grid: device screen per retirement cohort,
    # WGL checker over the suspects in the overlapped host phase
    screen_fn = None
    if target.hist_spec is not None:
        from ..oracle.screen import screen_for, screen_sweep

        if screen_for(target.hist_spec) is not None:
            def screen_fn(final):
                return screen_sweep(final, target.hist_spec, mesh=mesh)

    def host_work(final, *, lo, n, seeds, suspect, summary) -> dict:
        del lo, n, seeds
        if suspect is not None:
            from ..oracle.check import violating_seeds

            vio = violating_seeds(
                final, target.hist_spec, screen=lambda _f: suspect,
                workers=ccfg.check_workers,
            )
        else:
            vio = np.asarray(target.violating(final))
        out = {
            "violating_seeds": [int(x) for x in vio[: ccfg.max_recorded_seeds]]
        }
        if "violations" not in summary:
            out["violations"] = int(vio.size)
        return out

    # decided-but-unfed segments, in decision order; chunk bookkeeping
    ready: List[dict] = []
    chunk_owner: Dict[int, int] = {}  # chunk lo -> decision index
    cand: List[dict] = []  # per decision: spec/mask/chunks/partial
    item_prio: List[int] = []  # per queue item: 0 = escalated (jump queue)
    next_item = 0
    corpus: List[object] = []
    records: List[dict] = []
    failures: List[Tuple[object, int]] = []
    seen_failures: set = set()
    global_map: List[int] = []
    seen_fps: set = set()
    first_bug_recorded = False

    def can_decide() -> bool:
        if sched.t >= ccfg.rounds:
            return False
        if scfg.budget_events and sched.spent_events >= scfg.budget_events:
            return False
        return True

    def push_decision() -> None:
        nonlocal next_item
        rec = sched.decide()
        mask = int(rec["family"], 16)
        spec = family_candidate(
            base_spec, mask, ccfg.campaign_seed, rec["lineage"],
            ccfg.mutations_hi,
        )
        m = rec["seeds"]
        for t in range(m // s0):
            chunk_owner[next_item + t * s0] = rec["i"]
        cand.append(
            {
                "rec": rec,
                "mask": mask,
                "spec": spec,
                "chunks": m // s0,
                "landed": 0,
                "partial": {},
            }
        )
        item_prio.extend([0 if rec["hot"] else 1] * m)
        next_item += m
        ready.append(
            {
                "seeds": np.arange(
                    ccfg.seed0, ccfg.seed0 + m, dtype=np.int64
                ),
                "params": tile_params(
                    spec_to_params(spec, envelope, target.num_nodes), m
                ),
                "budgets": np.full(m, rec["budget"], np.int32),
            }
        )
        if telemetry is not None:
            telemetry.count("steer_decisions_total", help="bandit decisions")
            telemetry.gauge(
                "steer_families_alive", len(sched.alive()),
                help="families not yet early-killed",
            )
            telemetry.event("steer_round", **_jfields(rec))

    def absorb(j: int) -> None:
        """Candidate ``j``'s chunks all flushed: score the outcome,
        fold it into the bandit, and decide the next candidate."""
        nonlocal global_map, first_bug_recorded
        c = cand[j]
        summary: dict = {}
        for t in sorted(c["partial"]):
            merge_summaries(summary, c["partial"][t])
        c["partial"] = None
        spec, mask, rec = c["spec"], c["mask"], c["rec"]
        cand_map = [int(w) for w in summary.get("coverage_map", [])]
        if len(global_map) < len(cand_map):
            global_map += [0] * (len(cand_map) - len(global_map))
        new_bits = sum(
            (cw & ~g).bit_count() for cw, g in zip(cand_map, global_map)
        )
        retained = j == 0 or new_bits > 0
        if retained:
            corpus.append(spec)
            global_map = [g | cw for g, cw in zip(global_map, cand_map)]
        all_vio = summary.get("violating_seeds", [])
        # the device latch undercounts targets whose violations only the
        # history checker sees (etcd stale reads): take the max of the
        # two deterministic signals
        vio_n = max(int(summary.get("violations", 0)), len(all_vio))
        vio = all_vio[: ccfg.max_recorded_seeds]
        fresh_fps: List[str] = []
        dup = 0
        for seed in vio:
            f = triage_seed(
                target, envelope, int(seed), history=hist_triage,
                params=spec_to_params(spec, envelope, target.num_nodes),
                device=dev,
            )
            if f is None:
                continue
            if f.fingerprint in seen_fps:
                dup += 1
            else:
                seen_fps.add(f.fingerprint)
                fresh_fps.append(f.fingerprint)
            if (spec, int(seed)) not in seen_failures:
                seen_failures.add((spec, int(seed)))
                failures.append((spec, int(seed)))
        events = int(summary.get("events_total", 0)) or rec["seeds"]
        out = sched.absorb(
            mask,
            {
                "events": events,
                "new_bits": new_bits,
                "vio": vio_n,
                "fresh": len(fresh_fps),
                "dup": dup,
            },
        )
        records.append(
            {
                "round": j,
                "family": family_key(mask),
                "lineage": rec["lineage"],
                "spec": spec_to_dict(spec),
                "seeds": [ccfg.seed0, ccfg.seed0 + rec["seeds"]],
                "budget": rec["budget"],
                "violations": vio_n,
                "violating_seeds": [int(x) for x in vio],
                "coverage_bits": coverage_bit_count(cand_map),
                "new_bits": new_bits,
                "coverage_total_bits": coverage_bit_count(global_map),
                "retained": retained,
                "events_total": int(summary.get("events_total", 0)),
                "fresh_fingerprints": fresh_fps,
                "dup_fingerprints": dup,
            }
        )
        if telemetry is not None:
            telemetry.count("steer_outcomes_total", help="outcomes absorbed")
            telemetry.gauge(
                "steer_spent_events", sched.spent_events,
                help="deterministic device-event budget spent",
            )
            if fresh_fps:
                telemetry.count(
                    "steer_fresh_fingerprints_total", len(fresh_fps),
                    help="first-seen triage fingerprints",
                )
            if dup:
                telemetry.count(
                    "steer_dup_fingerprints_total", dup,
                    help="recorded violating seeds with a known fingerprint",
                )
            if sched.killed:
                telemetry.gauge(
                    "steer_kills_total", len(sched.killed),
                    help="families early-killed",
                )
            if sched.escalated:
                telemetry.gauge(
                    "steer_escalations_total", len(sched.escalated),
                    help="families escalated after a first violation",
                )
            if failures and not first_bug_recorded:
                first_bug_recorded = True
                telemetry.gauge(
                    "steer_time_to_first_bug_seconds",
                    _time.perf_counter() - t0_wall,
                    help="wall time from steered-campaign start to first "
                    "failure (out-of-band; decisions never read it)",
                )
            telemetry.event("steer_round", **_jfields(out))
        if can_decide():
            push_decision()

    def on_chunk(*, lo, k, summary):  # noqa: ANN001 - stream contract
        del k
        j = chunk_owner.pop(lo)
        c = cand[j]
        c["partial"][lo] = summary
        c["landed"] += 1
        if c["landed"] == c["chunks"]:
            absorb(j)

    def feed() -> Optional[dict]:
        if not ready:
            return None
        return ready.pop(0)

    def reprioritize(tail: np.ndarray) -> Optional[np.ndarray]:
        prio = np.asarray(item_prio, np.int64)[tail]
        if prio.size < 2 or (prio == prio[0]).all():
            return None
        if telemetry is not None:
            telemetry.count(
                "steer_reorders_total",
                help="escalated families jumped the dispatch queue",
            )
        return tail[np.argsort(prio, kind="stable")]

    for _ in range(max(1, scfg.pipeline)):
        if can_decide():
            push_decision()

    if ready:
        first = ready
        ready = []
        init = {
            "seeds": np.concatenate([seg["seeds"] for seg in first]),
            "params": None,
            "budgets": np.concatenate([seg["budgets"] for seg in first]),
        }
        init["params"] = tree.map(
            lambda *xs: np.concatenate([np.asarray(x) for x in xs]),
            *[seg["params"] for seg in first],
        )
        stream_sweep(
            workload, ecfg, init["seeds"], target.summarize,
            params=init["params"], budgets=init["budgets"],
            chunk_size=s0,
            pool_size=s0 * max(1, scfg.pipeline),
            host_work=host_work, screen=screen_fn, mesh=mesh,
            on_chunk=on_chunk, feed=feed, reprioritize=reprioritize,
            telemetry=telemetry, device=dev,
        )

    header = {
        "campaign": ccfg._asdict(),
        "steer": scfg._asdict(),
        "target": target.name,
        "base_spec": spec_to_dict(base_spec),
    }
    # every rank holds the same records and trace; rank 0 writes them
    writer = mesh is None or mesh.rank == 0
    if report_path is not None and writer:
        with open(report_path, "w") as f:
            f.write(json.dumps(header, sort_keys=True) + "\n")
            for rec in records:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
    if trace_path is not None and writer:
        with open(trace_path, "w") as f:
            f.write(json.dumps(header, sort_keys=True) + "\n")
            f.write(sched.trace_lines())

    return SteerResult(
        corpus=corpus,
        records=records,
        failures=failures,
        coverage_map=global_map,
        decisions=list(sched.trace),
        fingerprints=sorted(seen_fps),
        spent_events=sched.spent_events,
    )
