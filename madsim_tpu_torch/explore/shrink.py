"""Schedule shrinking: ddmin a failure down to a minimal replayable triple
(counterpart of ``madsim_tpu/explore/shrink.py``).

A campaign failure arrives as ``(spec, seed)`` — a fault environment plus
the seed whose schedule broke the workload. The shrinker turns that into
the smallest artifact that still reproduces:

1. extract the seed's *fired* fault schedule from a bit-exact
   ``run_traced`` replay (exact payload-carried deadlines);
2. refit it as a literal ``FixedFaults`` schedule — injecting the same
   events at the same deadlines reproduces the identical trajectory, so
   this step is verified, not assumed;
3. ddmin (Zeller/Hildebrandt delta debugging) over the event list: each
   candidate subset re-verifies by replay through ``triage_seed`` and
   survives iff the SAME failure fingerprint latches — never merely
   "some failure";
4. the result is 1-minimal: removing any single remaining event loses
   the failure (the ddmin guarantee when it terminates normally).

Every reported failure thus lands as a minimal ``(spec, seed, schedule)``
triple that a device replay and the host tier's schedule supervisor
consume directly.

``narrow_windows`` is the campaign-side counterpart: clamp a spec's
windows to just cover a shrunk schedule's fire times (and drop categories
that contributed nothing), focusing the NEXT exploration rounds. A
narrowed spec redraws its schedule, so it is not seed-stable — the
``FixedFaults`` triple is the reproducing artifact; the narrowed spec is
a better search start.

Replay channel: ddmin candidates replay through spec-as-data
(engine/faults.py) as the reference's do — one ``FaultEnvelope(fixed=W)``
per failure, ``W`` the original schedule length rounded up to a power
of two, each candidate fed in as ``FaultParams`` (bit-identical to a
static ``FixedFaults`` config). Eager torch compiles nothing, so this
keeps the reference's replays, not a saving; ``max_tests`` bounds the
replay count because each replay is a real traced run.

Every replay runs on ``device`` (None means CUDA).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

from ..engine import core as ecore
from ..engine.faults import FixedFaults
from ..replay import FaultEvent, extract_fault_schedule
from .targets import Target
from .triage import Failure, triage_seed

# (spec count field, window field, schedule "on" action) per category
_CATEGORIES = (
    ("crashes", "crash_window_ns", "crash"),
    ("partitions", "part_window_ns", "partition"),
    ("spikes", "spike_window_ns", "spike_on"),
    ("losses", "loss_window_ns", "loss_on"),
    ("pauses", "pause_window_ns", "pause"),
)


class ShrinkResult(NamedTuple):
    """A minimal, re-verified failure artifact."""

    spec: FixedFaults  # run this (any tier, any seed-stability concern gone)
    seed: int  # the engine seed the workload draws flow from
    schedule: Tuple[FaultEvent, ...]  # == spec.events, time-sorted
    fingerprint: str  # the failure class this still reproduces
    failure: Failure  # triage of the minimal replay
    tests: int  # replays the shrink spent
    original_len: int  # fired-schedule length before shrinking


def to_fixed(spec, events: Sequence[FaultEvent]) -> FixedFaults:
    """Refit a schedule as a literal spec, carrying over the burst and
    clock-skew override values (both spec flavors have them)."""
    return FixedFaults(
        events=tuple(events),
        spike_lat_lo_ns=spec.spike_lat_lo_ns,
        spike_lat_hi_ns=spec.spike_lat_hi_ns,
        burst_loss_q32=spec.burst_loss_q32,
        skew_num=spec.skew_num,
        skew_den=spec.skew_den,
    )


def ddmin(
    events: List[FaultEvent],
    test: Callable[[List[FaultEvent]], bool],
    max_tests: int = 64,
    spent: Optional[Callable[[], int]] = None,
) -> Tuple[List[FaultEvent], int]:
    """Classic ddmin over a fault-event list. ``test`` must hold for
    ``events`` on entry; returns the reduced list (1-minimal unless the
    ``max_tests`` budget ran out first) and the budget consumed.

    ``spent`` overrides the budget meter: pass a callable returning the
    REAL cost so far (e.g. cache-missing replays only) so memoized
    re-tests of an already-tried subset don't burn budget; the default
    meter counts every ``test`` call."""
    n = 2
    calls = 0
    used = spent if spent is not None else lambda: calls
    while len(events) >= 2 and used() < max_tests:
        size = len(events)
        chunk = (size + n - 1) // n
        reduced = False
        for lo in range(0, size, chunk):
            cand = events[:lo] + events[lo + chunk :]
            calls += 1
            if test(cand):
                events = cand
                n = max(n - 1, 2)
                reduced = True
                break
            if used() >= max_tests:
                break
        if not reduced:
            if n >= size:
                break
            n = min(size, 2 * n)
    return events, used()


def shrink(
    target: Target, spec, seed: int, max_tests: int = 64,
    history: bool = False, device=None,
) -> Optional[ShrinkResult]:
    """Shrink one ``(spec, seed)`` failure to a minimal verified triple.

    Returns None when the seed does not violate under ``spec``, or when
    the refit literal schedule fails to reproduce the fingerprint (a
    schedule event past the engine horizon would be the usual cause —
    see ``replay.extract_fault_schedule``).

    ``history=True`` re-verifies every ddmin candidate through the
    history oracle (``triage_seed(..., history=True)`` — decode the
    candidate replay's op history, reject iff the linearizability
    checker still rejects with the same fingerprint) instead of the
    model probe; the resulting minimal triple is thus checker-verified,
    not probe-verified."""
    f0 = triage_seed(target, spec, seed, history=history, device=device)
    if f0 is None:
        return None
    workload, ecfg = target.build(spec)
    _, trace = ecore.run_traced(workload, ecfg, seed, device=device)
    full = extract_fault_schedule(trace, target.fault_kind)

    # spec-as-data replay channel: one traced program per envelope WIDTH
    # (len(full) rounded up to a power of two — candidates are subsets,
    # and comparably-sized failures share the program), each candidate
    # fed in as runtime FaultParams
    from ..engine.faults import FaultEnvelope, spec_to_params

    width = 4
    while width < len(full):
        width *= 2
    env = FaultEnvelope(fixed=width)

    # memoize replays by event tuple: ddmin's regranulation can revisit a
    # subset, and the final verification is always the last accepted
    # test — each replay costs a real traced run (see the module cost
    # note), so none repeats and only real replays burn the max_tests
    # budget
    replayed: dict = {}

    def run(events: List[FaultEvent]) -> Optional[Failure]:
        key = tuple(events)
        if key not in replayed:
            fixed = to_fixed(spec, events)
            replayed[key] = triage_seed(
                target, env, seed, history=history,
                params=spec_to_params(fixed, env, target.num_nodes),
                device=device,
            )
        return replayed[key]

    def reproduces(events: List[FaultEvent]) -> bool:
        f = run(events)
        return f is not None and f.fingerprint == f0.fingerprint

    if not reproduces(full):
        return None
    minimal, _ = ddmin(
        full, reproduces, max_tests=max_tests, spent=lambda: len(replayed)
    )
    fixed = to_fixed(spec, minimal)
    final = run(minimal)  # cached: ddmin only returns verified subsets
    assert final is not None and final.fingerprint == f0.fingerprint
    return ShrinkResult(
        spec=fixed,
        seed=int(seed),
        schedule=fixed.events,
        fingerprint=f0.fingerprint,
        failure=final,
        tests=len(replayed),  # distinct replays actually executed
        original_len=len(full),
    )


def narrow_windows(spec, schedule: Sequence[FaultEvent]):
    """Clamp a ``FaultSpec``'s campaign windows to just cover a (shrunk)
    schedule's fire times; categories that contributed no event drop to
    zero phases. The result redraws (NOT seed-stable — the literal
    ``FixedFaults`` is the reproducing artifact); use it to focus the
    next campaign rounds on the neighborhood that already failed."""
    if isinstance(spec, FixedFaults):
        raise TypeError("narrow_windows narrows FaultSpec campaigns; a "
                        "FixedFaults schedule has no windows to narrow")
    ons = {action: [] for _, _, action in _CATEGORIES}
    for t, action, _ in schedule:
        if action in ons:
            ons[action].append(t)
    updates = {}
    for count_f, window_f, action in _CATEGORIES:
        if not getattr(spec, count_f):
            continue
        times = ons[action]
        if times:
            updates[window_f] = max(times) + 1
        else:
            updates[count_f] = 0
    return spec._replace(**updates)
