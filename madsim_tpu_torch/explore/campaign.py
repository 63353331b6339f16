"""The corpus-driven campaign loop: coverage-guided FaultSpec search
(counterpart of ``madsim_tpu/explore/campaign.py``).

AFL's loop lifted onto the sweep engine: keep a corpus of fault specs,
mutate one (seeded draws — the whole campaign is a pure function of
``campaign_seed``), sweep the candidate over a pinned seed range, and
retain it iff the sweep lights coverage bits no earlier candidate
reached. The coverage signal is the engine's per-seed
(kind x node x transition) bitmap, OR-reduced into each chunk summary
(``coverage_map``) — so guidance costs one extra reduction per chunk,
never a second pass over the sweep.

The seed range is the SAME for every candidate on purpose: coverage and
violation differences between rounds are then attributable to the spec
alone (the swarm-testing idiom — vary the fault mix, not the luck).

Violating seeds surface in each round's record; chain them into
``triage`` (dedupe by fingerprint) and ``shrink`` (minimal reproducing
schedule). Long campaigns resume through the existing
``engine/checkpoint.py`` machinery: with ``ckpt_dir`` set, every round's
sweep checkpoints per-chunk summaries, and a restarted campaign (same
config — candidates regenerate identically from the campaign seed) skips
every chunk already on disk.

The JSONL report is deterministic BY CONTRACT: records carry no wall
times or absolute paths, and keys are sorted — two runs of one campaign
seed produce byte-identical reports, equal to the reference's bytes for
the same inputs on any world size.

Every sweep runs on ``device`` (None means CUDA), or on ``mesh``'s ranks.
``scheduler="bandit"`` hands the loop to the self-steering scheduler
(``explore.steer.run_steered``).
"""

from __future__ import annotations

import json
import os
import random
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..engine.faults import (
    FaultEnvelope,
    FaultSpec,
    FixedFaults,
    campaign_envelope,
    prob_to_q32,
    spec_to_params,
    tile_params,
)
from ..models._common import coverage_bit_count
from .targets import Target

# mutation clamps: windows/durations stay inside a sane explore envelope
_MIN_NS = 10_000_000  # 10 ms
_MAX_NS = 8_000_000_000  # 8 s
_MAX_PHASES = 6  # per category
# the gray-failure families (aparts/fsync_stalls/power_fails/skews,
# engine/faults.py) are first-class mutation targets: coverage-guided
# search explores one-directional partitions, crash-without-sync and
# clock drift the same way it explores clean crashes
_COUNT_FIELDS = (
    "crashes", "partitions", "spikes", "losses", "pauses",
    "aparts", "fsync_stalls", "power_fails", "skews",
)
_WINDOW_FIELDS = (
    "crash_window_ns",
    "part_window_ns",
    "spike_window_ns",
    "loss_window_ns",
    "pause_window_ns",
    "apart_window_ns",
    "fsync_window_ns",
    "power_window_ns",
    "skew_window_ns",
)
_DUR_FIELDS = (
    ("restart_lo_ns", "restart_hi_ns"),
    ("part_lo_ns", "part_hi_ns"),
    ("spike_dur_lo_ns", "spike_dur_hi_ns"),
    ("loss_dur_lo_ns", "loss_dur_hi_ns"),
    ("pause_lo_ns", "pause_hi_ns"),
    ("apart_lo_ns", "apart_hi_ns"),
    ("fsync_lo_ns", "fsync_hi_ns"),
    ("power_lo_ns", "power_hi_ns"),
    ("skew_lo_ns", "skew_hi_ns"),
)
# scale factors as exact integer ratios (float scaling would make the
# mutated spec depend on platform rounding)
_SCALES = ((1, 2), (2, 3), (3, 2), (2, 1))


class CampaignConfig(NamedTuple):
    """Static campaign parameters (hashable, reprs stably).

    ``check_workers`` fans the history checker of a screened target over
    a process pool (``oracle.check.check_histories``) — wall-clock only,
    never a report byte, so it is safe to vary per machine. The report
    HEADER records the whole config, so compare reports only across runs
    of one config (the determinism gates do)."""

    rounds: int = 12
    seeds_per_round: int = 256
    seed0: int = 0  # the pinned sweep seed range is [seed0, seed0 + n)
    campaign_seed: int = 0  # drives parent choice + mutations
    chunk_size: int = 16384
    mutations_hi: int = 2  # 1..hi mutations per candidate
    stop_after_failures: int = 0  # stop once this many seeds violate (0 = never)
    max_recorded_seeds: int = 8  # violating seeds listed per round record
    check_workers: int = 0  # process-pool size for history checking
    # candidates swept per device launch (spec-as-data only): batch > 1
    # generates that many candidates from the CURRENT corpus snapshot
    # and sweeps them as ONE (candidate x seed) grid — retention still
    # applies in candidate order, but parents within a block are drawn
    # before the block's results land, so batch changes the (still
    # deterministic) campaign trajectory; batch=1 is the exact serial
    # semantics the byte-identity gates pin
    batch: int = 1
    # compute-allocation policy: "uniform" is this module's classic
    # corpus loop; "bandit" routes run_campaign to the self-steering
    # scheduler (explore/steer.py: family-partitioned candidates, UCB
    # allocation, early-kill and escalation over one stream_sweep)
    scheduler: str = "uniform"


class CampaignResult(NamedTuple):
    corpus: List[object]  # retained specs, oldest first (corpus[0] = base)
    records: List[dict]  # one per executed round (the JSONL lines)
    failures: List[Tuple[object, int]]  # (spec, violating seed), dedup order
    coverage_map: List[int]  # global union bitmap words


def _clamp_ns(v: int) -> int:
    return max(_MIN_NS, min(_MAX_NS, int(v)))


def _scale(rng: random.Random, v: int) -> int:
    num, den = rng.choice(_SCALES)
    return v * num // den


def mutate_spec(
    spec: FaultSpec, rng: random.Random, mutations_hi: int = 2
) -> FaultSpec:
    """One candidate: 1..``mutations_hi`` seeded mutations of ``spec``.

    Mutations are the swarm-testing moves — add/drop a
    storm or partition phase, widen/narrow a campaign window, scale
    restart/burst durations and rates — all integer arithmetic, so a
    mutated spec is identical across platforms for one rng state."""
    for _ in range(rng.randint(1, max(1, mutations_hi))):
        # weighted op choice: phase-count changes are the coarse knob
        # that opens whole fault categories, so they get extra weight
        op = rng.choice(
            ("add", "add", "add", "drop", "window", "window", "dur", "rate")
        )
        if op == "add":
            f = rng.choice(_COUNT_FIELDS)
            spec = spec._replace(**{f: min(getattr(spec, f) + 1, _MAX_PHASES)})
        elif op == "drop":
            live = [f for f in _COUNT_FIELDS if getattr(spec, f) > 0]
            if live:
                f = rng.choice(live)
                spec = spec._replace(**{f: getattr(spec, f) - 1})
        elif op == "window":
            f = rng.choice(_WINDOW_FIELDS)
            spec = spec._replace(**{f: _clamp_ns(_scale(rng, getattr(spec, f)))})
        elif op == "dur":
            lo_f, hi_f = rng.choice(_DUR_FIELDS)
            num, den = rng.choice(_SCALES)
            lo = _clamp_ns(getattr(spec, lo_f) * num // den)
            hi = _clamp_ns(getattr(spec, hi_f) * num // den)
            spec = spec._replace(**{lo_f: lo, hi_f: max(hi, lo + 1)})
        else:  # rate: burst loss probability / spike latency range
            if rng.random() < 0.5:
                q = _scale(rng, spec.burst_loss_q32)
                spec = spec._replace(
                    burst_loss_q32=max(
                        prob_to_q32(0.05), min(prob_to_q32(0.95), q)
                    )
                )
            else:
                num, den = rng.choice(_SCALES)
                lo = _clamp_ns(spec.spike_lat_lo_ns * num // den)
                hi = _clamp_ns(spec.spike_lat_hi_ns * num // den)
                spec = spec._replace(
                    spike_lat_lo_ns=lo, spike_lat_hi_ns=max(hi, lo + 1)
                )
    return spec


def spec_to_dict(spec) -> dict:
    """JSON-stable encoding of a ``FaultSpec`` or ``FixedFaults``."""
    if isinstance(spec, FixedFaults):
        return {
            "type": "FixedFaults",
            "events": [[t, a, v] for t, a, v in spec.events],
            "spike_lat_lo_ns": spec.spike_lat_lo_ns,
            "spike_lat_hi_ns": spec.spike_lat_hi_ns,
            "burst_loss_q32": spec.burst_loss_q32,
            "skew_num": spec.skew_num,
            "skew_den": spec.skew_den,
        }
    d = {"type": "FaultSpec"}
    for f, v in zip(spec._fields, spec):
        d[f] = list(v) if isinstance(v, tuple) else v
    return d


def spec_from_dict(d: dict):
    """Inverse of ``spec_to_dict`` (report lines back to runnable specs)."""
    d = dict(d)
    kind = d.pop("type")
    if kind == "FixedFaults":
        defaults = FixedFaults()
        return FixedFaults(
            events=tuple((int(t), str(a), int(v)) for t, a, v in d["events"]),
            spike_lat_lo_ns=int(d["spike_lat_lo_ns"]),
            spike_lat_hi_ns=int(d["spike_lat_hi_ns"]),
            burst_loss_q32=int(d["burst_loss_q32"]),
            # .get: report lines written before the gray grammar lack them
            skew_num=int(d.get("skew_num", defaults.skew_num)),
            skew_den=int(d.get("skew_den", defaults.skew_den)),
        )
    if kind != "FaultSpec":
        raise ValueError(f"unknown spec encoding {kind!r}")
    return FaultSpec(
        **{f: tuple(v) if isinstance(v, list) else v for f, v in d.items()}
    )


def target_envelope(target: Target, *specs, fixed: int = 0) -> FaultEnvelope:
    """The campaign envelope for ``target``: covers every given spec
    plus the mutator's ``_MAX_PHASES`` clamp, so every candidate any
    campaign round can generate fits one workload shape."""
    return campaign_envelope(*specs, mutation_cap=_MAX_PHASES, fixed=fixed)


def _candidate_params(target: Target, spec, envelope: FaultEnvelope, lanes: int):
    """Per-lane FaultParams for one candidate over a ``lanes``-seed
    range (host numpy — validation is eager, tracing sees arrays)."""
    return tile_params(
        spec_to_params(spec, envelope, target.num_nodes), lanes
    )


def _sweep_candidate(
    target: Target,
    spec,
    ccfg: CampaignConfig,
    round_dir: Optional[str],
    mesh=None,
    on_chunk=None,
    envelope: Optional[FaultEnvelope] = None,
    telemetry=None,
    device=None,
) -> dict:
    """Run one candidate's sweep over the pinned seed range; returns the
    merged summary dict (coverage_map + violating_seeds included).
    ``mesh`` shards the whole pipeline (sweep, screen, summary) over the
    device mesh; the summary bytes are mesh-size-invariant.

    With ``envelope`` the candidate rides in as spec-as-data: the
    workload is built from the ENVELOPE and the concrete spec becomes
    per-lane ``FaultParams``, as the reference does it. The summary
    bytes are identical either way (the padded schedule derivation is
    bit-exact)."""
    if envelope is None:
        workload, ecfg = target.build(spec)
        params = None
    else:
        workload, ecfg = target.build(envelope)
        params = _candidate_params(
            target, spec, envelope, ccfg.seeds_per_round
        )
    if workload.cover is None or workload.cover_bits == 0:
        raise ValueError(
            f"target {target.name!r} workload defines no coverage signal "
            "(Workload.cover/cover_bits); without it the campaign loop "
            "degenerates to unguided mutation of the base spec"
        )
    seeds = np.arange(
        ccfg.seed0, ccfg.seed0 + ccfg.seeds_per_round, dtype=np.int64
    )
    # never let the chunk granule exceed the round budget (the
    # reference's rule; its summaries depend on the granule only
    # through the chunk boundaries)
    chunk_size = min(ccfg.chunk_size, ccfg.seeds_per_round)

    # history targets hand the pipeline their device screen, run right
    # behind each chunk's sweep
    screen_fn = None
    if target.hist_spec is not None:
        from ..oracle.screen import screen_for, screen_sweep

        if screen_for(target.hist_spec) is not None:
            def screen_fn(final):
                return screen_sweep(final, target.hist_spec, mesh=mesh)

    def host_work(final, *, lo, n, seeds, suspect, summary) -> dict:
        # the expensive half — checking may run the WGL search per
        # suspect lane — runs in the pipeline's host phase
        del lo, n, seeds
        if suspect is not None:
            # consume the mask the device phase already computed
            # (identical seeds to target.violating, by conservatism)
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
            # the uncapped truth, so the round record never under-reports
            # for a target whose summary lacks the key (sums per chunk)
            out["violations"] = int(vio.size)
        return out

    # one driver for both legs: with round_dir the per-chunk summaries
    # checkpoint (a restarted campaign regenerates the same candidate —
    # pure function of campaign_seed — and skips finished chunks).
    # A mesh lifts the same pipeline onto all ranks — sharded sweep +
    # screen + summary, identical report bytes on any world size.
    if mesh is not None:
        from ..parallel.mesh import run_sweep_sharded_pipelined

        return run_sweep_sharded_pipelined(
            workload, ecfg, seeds, target.summarize, mesh=mesh,
            host_work=host_work, screen=screen_fn, chunk_size=chunk_size,
            ckpt_dir=round_dir, on_chunk=on_chunk, params=params,
            telemetry=telemetry,
        )
    from ..engine.checkpoint import run_sweep_pipelined

    return run_sweep_pipelined(
        workload, ecfg, seeds, target.summarize, host_work=host_work,
        screen=screen_fn, chunk_size=chunk_size, ckpt_dir=round_dir,
        on_chunk=on_chunk, params=params, telemetry=telemetry,
        device=device,
    )


def sweep_candidate_grid(
    target: Target,
    specs: Sequence,
    ccfg: CampaignConfig,
    envelope: FaultEnvelope,
    mesh=None,
    telemetry=None,
    device=None,
) -> List[dict]:
    """Sweep K candidates as ONE (candidate x seed) device grid and
    return each candidate's summary dict — identical values to K calls
    of ``_sweep_candidate`` over the same pinned seed range.

    The K * seeds_per_round (candidate x seed) work items feed the lane
    pool of ``engine.stream.stream_sweep`` (sharded over ``mesh`` when
    given) instead of chunk boundaries: a candidate whose seeds all
    finish early releases its lanes to the next candidate mid-flight.
    The virtual chunk granule is ONE candidate
    (``chunk_size=seeds_per_round``), so each flushed chunk summary IS
    that candidate's summary — identical values to K calls of
    ``_sweep_candidate``, and refill-schedule-invariant by the stream
    contract."""
    from ..engine.faults import grid_params
    from ..engine.stream import stream_sweep

    workload, ecfg = target.build(envelope)
    if workload.cover is None or workload.cover_bits == 0:
        raise ValueError(
            f"target {target.name!r} workload defines no coverage signal "
            "(Workload.cover/cover_bits); without it the campaign loop "
            "degenerates to unguided mutation of the base spec"
        )
    s = ccfg.seeds_per_round
    k = len(specs)
    seeds = np.tile(
        np.arange(ccfg.seed0, ccfg.seed0 + s, dtype=np.int64), k
    )
    params = grid_params(
        [spec_to_params(spec, envelope, target.num_nodes) for spec in specs],
        s,
    )
    multiple = 1 if mesh is None else int(mesh.size)
    # the pool holds the same working set the chunked grid ran, rounded
    # up to mesh divisibility like every other sharded driver
    # (stream_sweep caps it to the total)
    pool = -(-max(ccfg.chunk_size, s) // multiple) * multiple

    # the serial pipeline's screen/host-work machinery, per candidate
    # chunk: the device screen (run once per retirement cohort) clears
    # the boring lanes and the WGL checker fans the suspects over the
    # process pool — mirrors _sweep_candidate exactly, which is what
    # keeps grid summaries byte-equal to serial rounds
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

    summaries: List[dict] = []
    stream_sweep(
        workload, ecfg, seeds, target.summarize,
        params=params, chunk_size=s, pool_size=pool,
        host_work=host_work, screen=screen_fn, mesh=mesh,
        on_chunk=lambda *, lo, k, summary: summaries.append(summary),
        telemetry=telemetry, device=device,
    )
    return summaries


def run_campaign(
    target: Target,
    base_spec: FaultSpec,
    ccfg: CampaignConfig = CampaignConfig(),
    report_path: Optional[str] = None,
    ckpt_dir: Optional[str] = None,
    mesh=None,
    on_chunk=None,
    telemetry=None,
    steer_cfg=None,
    trace_path: Optional[str] = None,
    history: bool = False,
    device=None,
) -> CampaignResult:
    """Drive the find loop: ``rounds`` candidates from ``base_spec``.

    Round 0 sweeps the base spec itself (the bland starting point);
    every later round mutates a uniformly drawn corpus parent. A
    candidate joins the corpus iff its sweep lit coverage bits the
    global union lacked. Stops early once ``stop_after_failures``
    violating seeds have surfaced (0 = run every round).

    ``report_path`` writes one JSONL record per executed round (plus a
    header) — deterministic bytes per campaign seed. ``ckpt_dir`` makes
    each round's sweep preemption-safe via per-chunk summary checkpoints
    (``engine/checkpoint.py``).

    ``mesh`` (a ``parallel.SeedMesh``; every rank calls with the same
    arguments) runs every round's checked sweep sharded over its ranks
    (``parallel.run_sweep_sharded_pipelined``); the JSONL report is
    BYTE-IDENTICAL to the same campaign on any other world size. Without
    a mesh the sweeps run on ``device`` (None means CUDA).
    ``on_chunk(lo=, k=, summary=)`` fires per merged chunk
    (time-to-first-violation instrumentation).

    The campaign envelope (``target_envelope``) is derived ONCE from the
    base spec + mutator clamps and every candidate rides in as per-lane
    ``FaultParams``. ``ccfg.batch > 1`` sweeps that many candidates per
    launch as one (candidate x seed) grid (``sweep_candidate_grid``);
    grid blocks skip per-round sweep checkpointing and per-chunk
    ``on_chunk`` callbacks (``ckpt_dir`` and ``on_chunk`` apply to
    serial rounds only).

    ``telemetry`` (duck-typed: ``count``/``gauge``/``observe``/``event``
    and what the sweep drivers use) rides through to every round's
    sweep driver and adds the campaign view: candidates/s, corpus size
    and global coverage-bit gauges, unique-vs-duplicate failure counters,
    time-to-first-bug, and one journal record per round. Strictly
    out of band — the report bytes are identical with it on or off.

    ``ccfg.scheduler="bandit"`` hands the whole loop to the
    self-steering scheduler (``explore.steer.run_steered``):
    family-partitioned candidates, UCB compute allocation, early-kill and
    budget escalation, with the decision trace written to ``trace_path``
    (deterministic bytes). ``steer_cfg`` (a ``steer.SteerConfig``) tunes
    the policy, ``history=True`` routes the steered loop's in-flight
    triage through the history oracle (required for targets whose
    violations only the WGL checker sees); ``ckpt_dir``/``on_chunk``
    apply to the classic uniform loop only."""
    import time as _time

    if ccfg.scheduler not in ("uniform", "bandit"):
        raise ValueError(f"unknown scheduler {ccfg.scheduler!r}")
    if ccfg.scheduler == "bandit":
        from .steer import run_steered

        return run_steered(
            target, base_spec, ccfg, steer_cfg, history=history,
            report_path=report_path, trace_path=trace_path,
            mesh=mesh, telemetry=telemetry, device=device,
        ).campaign_result()

    rng = random.Random(ccfg.campaign_seed)
    corpus: List[object] = []
    records: List[dict] = []
    failures: List[Tuple[object, int]] = []
    seen_failures = set()
    global_map: List[int] = []
    t0_wall = _time.perf_counter()
    vio_seen = vio_unique = 0  # dedup-hit-rate inputs (telemetry only)
    first_bug_recorded = False

    header = {
        "campaign": ccfg._asdict(),
        "target": target.name,
        "base_spec": spec_to_dict(base_spec),
    }

    envelope = target_envelope(target, base_spec)

    def gen(r: int):
        """Candidate r: the base spec for round 0, a seeded mutation of
        a drawn corpus parent after. In batch mode the block's
        candidates draw against the corpus SNAPSHOT — retention from
        earlier rounds of the block hasn't landed, so both the parent
        draws and the rng stream diverge from the serial trajectory
        (deterministically; see ``CampaignConfig.batch``)."""
        if r == 0:
            return None, base_spec
        parent = rng.randrange(len(corpus)) if corpus else None
        return parent, mutate_spec(
            corpus[parent] if parent is not None else base_spec,
            rng,
            ccfg.mutations_hi,
        )

    def absorb(r: int, parent, spec, summary: dict) -> bool:
        """Fold one candidate's summary into corpus/coverage/records;
        True = the failure budget is spent (stop the campaign)."""
        nonlocal global_map, vio_seen, vio_unique, first_bug_recorded
        cand_map = [int(w) for w in summary.get("coverage_map", [])]
        if len(global_map) < len(cand_map):
            global_map = global_map + [0] * (len(cand_map) - len(global_map))
        new_bits = sum(
            (c & ~g).bit_count() for c, g in zip(cand_map, global_map)
        )
        retained = r == 0 or new_bits > 0
        if retained:
            corpus.append(spec)
            global_map = [g | c for g, c in zip(global_map, cand_map)]

        vio = summary.get("violating_seeds", [])[: ccfg.max_recorded_seeds]
        fresh = 0
        for seed in vio:
            key = (spec, seed)
            if key not in seen_failures:
                seen_failures.add(key)
                failures.append((spec, seed))
                fresh += 1

        records.append(
            {
                "round": r,
                "parent": parent,
                "spec": spec_to_dict(spec),
                "seeds": [ccfg.seed0, ccfg.seed0 + ccfg.seeds_per_round],
                "violations": int(summary["violations"]),
                "violating_seeds": vio,
                "coverage_bits": coverage_bit_count(cand_map),
                "new_bits": new_bits,
                "coverage_total_bits": coverage_bit_count(global_map),
                "retained": retained,
                "events_total": int(summary.get("events_total", 0)),
            }
        )
        if telemetry is not None:
            elapsed = _time.perf_counter() - t0_wall
            vio_seen += len(vio)
            vio_unique += fresh
            telemetry.count(
                "campaign_candidates_total", help="candidates swept"
            )
            telemetry.gauge(
                "campaign_candidates_per_s",
                (r + 1) / max(elapsed, 1e-9),
                help="campaign throughput since start",
            )
            telemetry.gauge(
                "campaign_corpus_size", len(corpus),
                help="retained specs in the corpus",
            )
            telemetry.gauge(
                "campaign_coverage_bits", coverage_bit_count(global_map),
                help="global coverage union population count",
            )
            if fresh:
                telemetry.count(
                    "campaign_failures_total", fresh,
                    help="unique (spec, seed) failures",
                )
            if len(vio) - fresh:
                telemetry.count(
                    "campaign_failure_dupes_total", len(vio) - fresh,
                    help="violating seeds already in the dedup set",
                )
            if vio_seen:
                telemetry.gauge(
                    "campaign_dedup_hit_rate",
                    (vio_seen - vio_unique) / vio_seen,
                    help="fraction of observed failures already known",
                )
            if failures and not first_bug_recorded:
                first_bug_recorded = True
                telemetry.gauge(
                    "campaign_time_to_first_bug_seconds", elapsed,
                    help="wall time from campaign start to first failure",
                )
            telemetry.event(
                "round", round=r, retained=bool(retained),
                new_bits=int(new_bits), violations=len(vio),
                corpus=len(corpus),
            )
        return bool(
            ccfg.stop_after_failures
            and len(failures) >= ccfg.stop_after_failures
        )

    stop = False
    r = 0
    while r < ccfg.rounds and not stop:
        if ccfg.batch > 1:
            block = [
                gen(r + i) for i in range(min(ccfg.batch, ccfg.rounds - r))
            ]
            # a ragged tail block is padded back to the full batch width
            # (repeat the last candidate, discard its extra summaries),
            # as the reference pads it
            specs = [spec for _, spec in block]
            specs += [specs[-1]] * (ccfg.batch - len(block))
            summaries = sweep_candidate_grid(
                target, specs, ccfg, envelope, mesh=mesh,
                telemetry=telemetry, device=device,
            )[: len(block)]
            for (parent, spec), summary in zip(block, summaries):
                stop = absorb(r, parent, spec, summary)
                r += 1
                if stop:
                    break
        else:
            parent, spec = gen(r)
            round_dir = (
                os.path.join(ckpt_dir, f"round_{r:04d}") if ckpt_dir else None
            )
            summary = _sweep_candidate(
                target, spec, ccfg, round_dir, mesh=mesh, on_chunk=on_chunk,
                envelope=envelope, telemetry=telemetry, device=device,
            )
            stop = absorb(r, parent, spec, summary)
            r += 1

    if report_path is not None and (mesh is None or mesh.rank == 0):
        # every rank holds the same records; rank 0 writes them
        with open(report_path, "w") as f:
            f.write(json.dumps(header, sort_keys=True) + "\n")
            for rec in records:
                f.write(json.dumps(rec, sort_keys=True) + "\n")

    return CampaignResult(
        corpus=corpus,
        records=records,
        failures=failures,
        coverage_map=global_map,
    )
