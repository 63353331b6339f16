"""WGL-style linearizability checking over decoded operation histories (the
port's copy of ``madsim_tpu/oracle/check.py``).

The checker is the Wing & Gong search as refined by Lowe and Porcupine:
depth-first over partial linearizations, where a pending op is a legal
next step iff (a) its invocation precedes the earliest completion among
pending ops — no completed op is illegally reordered past it — and (b)
the sequential spec accepts its observed result from the current
abstract state. Visited ``(linearized-set, state)`` pairs are memoized
(the trick that makes the search practical: many interleavings reach the
same set with the same state), and the spec's key partitioning keeps the
exponent at per-key contention instead of history length.

Open ops (invoked, never completed — a lost response) are *optional*:
they may be linearized anywhere after their invocation or omitted
entirely, exactly the Jepsen ``:info`` treatment. A PUT whose ack was
lost but whose value a later read observed is thereby explained; one
that never took effect is dropped.

The search is exponential in the worst case, so a ``max_states`` budget
bounds it; an exhausted budget returns ``decided=False`` and counts as
clean (the oracle never reports a violation it has not proven).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .history import History, Op, host
from .specs import Spec

_INF = 1 << 62


class CheckResult(NamedTuple):
    """Outcome of checking one history against one spec."""

    ok: bool  # linearizable (or undecided within budget)
    decided: bool  # False iff the state budget ran out first
    bad_index: int  # global index (into history.ops) of the first bad op
    bad_op: Optional[Op]
    reason: str
    states: int  # memoized states explored across all partitions


def _linearizable(
    ops: Sequence[Op], spec: Spec, max_states: int
) -> Tuple[bool, bool, int]:
    """One partition's WGL search: (ok, decided, states explored)."""
    n = len(ops)
    if n == 0:
        return True, True, 0
    invs = [op.invoke_ns for op in ops]
    rets = [op.complete_ns if op.complete else _INF for op in ops]
    complete_mask = 0
    for i, op in enumerate(ops):
        if op.complete:
            complete_mask |= 1 << i
    init = spec.init()
    seen = {(0, init)}
    stack: List[Tuple[int, object]] = [(0, init)]
    while stack:
        mask, state = stack.pop()
        if mask & complete_mask == complete_mask:
            return True, True, len(seen)
        pending = [i for i in range(n) if not (mask >> i) & 1]
        first_ret = min(rets[i] for i in pending)
        for i in pending:
            if invs[i] > first_ret:
                continue  # a completed op returned before this invoked
            ok, state2 = spec.apply(state, ops[i])
            if not ok:
                continue
            key = (mask | (1 << i), state2)
            if key not in seen:
                if len(seen) >= max_states:
                    return True, False, len(seen)
                seen.add(key)
                stack.append(key)
    return False, True, len(seen)


def _first_bad_in_partition(
    ops: Sequence[Op], spec: Spec, max_states: int
) -> int:
    """Per-PARTITION prefix scan (all ``ops`` must share one partition):
    length of the shortest non-linearizable prefix, or -1."""
    for k in range(1, len(ops) + 1):
        ok, decided, _ = _linearizable(ops[:k], spec, max_states)
        if decided and not ok:
            return k
    return -1


def first_bad_prefix(
    ops: Sequence[Op], spec: Spec, max_states: int = 200_000
) -> int:
    """Length of the shortest non-linearizable prefix of ``ops`` (in
    invoke order), or -1 if every prefix checks out. The last op of that
    prefix is the one the failure fingerprint anchors on: the earliest
    operation whose observation the sequential spec cannot explain.

    Partition-aware like ``check_history`` (each key's subhistory is
    checked independently; the returned length ends at the earliest bad
    op across partitions), so a linearizable multi-key history is never
    falsely rejected by cross-key state mixing."""
    first = -1
    parts = spec.partition(ops)
    for key in sorted(parts):
        indexed = parts[key]
        k = _first_bad_in_partition(
            [op for _, op in indexed], spec, max_states
        )
        if k > 0:
            j = indexed[k - 1][0] + 1
            first = j if first < 0 else min(first, j)
    return first


def check_history(
    hist: History, spec: Spec, max_states: int = 200_000
) -> CheckResult:
    """Check one decoded history against a sequential spec.

    Runs the spec's structural pre-pass, then the WGL search per
    partition (each key's subhistory is independent — Herlihy–Wing
    locality). On failure the result pins the first bad op: the earliest
    op, across failing partitions, ending a non-linearizable prefix."""
    ops = hist.ops
    s = spec.structural(ops)
    if s is not None:
        i, reason = s
        return CheckResult(
            ok=False, decided=True, bad_index=i, bad_op=ops[i],
            reason=reason, states=0,
        )
    states = 0
    decided = True
    bad: List[Tuple[int, int]] = []  # (invoke_ns, global index)
    parts = spec.partition(ops)
    for key in sorted(parts):
        indexed = parts[key]
        sub = [op for _, op in indexed]
        ok, dec, n = _linearizable(sub, spec, max_states)
        states += n
        decided = decided and dec
        if dec and not ok:
            k = _first_bad_in_partition(sub, spec, max_states)
            j = indexed[k - 1][0] if k > 0 else indexed[-1][0]
            bad.append((ops[j].invoke_ns, j))
    if not bad:
        return CheckResult(
            ok=True, decided=decided, bad_index=-1, bad_op=None,
            reason="" if decided else "state budget exhausted (undecided)",
            states=states,
        )
    _, j = min(bad)
    op = ops[j]
    return CheckResult(
        ok=False, decided=True, bad_index=j, bad_op=op,
        reason=f"no linearization explains {op.describe()}",
        states=states,
    )


def _check_job(args) -> CheckResult:
    """Top-level worker body (must pickle) for ``check_histories``."""
    hist, spec, max_states = args
    return check_history(hist, spec, max_states=max_states)


def check_histories(
    hists: Sequence[History],
    spec: Spec,
    max_states: int = 200_000,
    workers: int = 0,
) -> List[CheckResult]:
    """Check a batch of histories, optionally fanned over a process
    pool — the host half of the screened checked-sweep pipeline
    (oracle/screen.py + engine/checkpoint.run_sweep_pipelined).

    Determinism contract: results are returned in input order and each
    verdict is a pure function of ``(history, spec, max_states)``, so
    the worker count can only change wall-clock, never a byte of any
    downstream report.
    ``workers <= 1`` checks inline; the pool workers are clean
    interpreters (forkserver/spawn — never a fork of THIS process,
    whose torch threads make mid-pipeline forks deadlock-prone, and
    which may hold a CUDA context that a forked child cannot use)
    importing only the numpy-side checker modules, and the pool is
    created once per worker count. Falls back to inline checking where
    no multiprocessing context is available."""
    hists = list(hists)
    if workers and workers > 1 and len(hists) > 1:
        ex = _pool(workers)
        if ex is not None:
            from concurrent.futures.process import BrokenProcessPool

            jobs = [(h, spec, max_states) for h in hists]
            try:
                return list(
                    ex.map(
                        _check_job,
                        jobs,
                        chunksize=max(1, len(jobs) // (workers * 4)),
                    )
                )
            except BrokenProcessPool:
                # a worker died (OOM on a pathological history, OS
                # kill): the executor is permanently broken, so evict
                # it — the NEXT call re-forks a fresh pool — and check
                # this batch inline (same results: pure per-history
                # function) instead of failing the remaining chunks
                _POOLS.pop(workers, None)
                ex.shutdown(wait=False, cancel_futures=True)
    return [check_history(h, spec, max_states=max_states) for h in hists]


def _pool(workers: int):
    """Process pool for ``check_histories``, cached per worker count —
    a checked sweep calls in once per chunk, and re-spawning a pool per
    chunk would cost more than small chunks' checking. NOT the fork
    context: by the time the pipeline's host phase runs, this process
    carries live torch threads (and maybe a CUDA context), and forking
    a multithreaded process can deadlock the child inside a held lock —
    a hung (not dead) worker never breaks the pool, so the whole sweep
    would block.
    forkserver (preferred: its server is a clean single-threaded
    process that forks cheap workers) or spawn both start workers as
    fresh interpreters importing only the numpy-side checker modules —
    a one-time start-up cost the persistent pool amortizes.
    Returns None where neither context exists (callers check inline)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    ex = _POOLS.get(workers)
    if ex is None and workers not in _POOLS:
        ctx = None
        for method in ("forkserver", "spawn"):
            try:
                ctx = mp.get_context(method)
                break
            except ValueError:
                continue
        ex = (
            ProcessPoolExecutor(max_workers=workers, mp_context=ctx)
            if ctx is not None
            else None
        )
        _POOLS[workers] = ex
    return ex


_POOLS: dict = {}


def shutdown_pools() -> None:
    """Stop every cached checker pool and wait for its workers to exit
    (the next ``check_histories`` with workers starts a fresh one)."""
    while _POOLS:
        _, ex = _POOLS.popitem()
        if ex is not None:
            ex.shutdown(wait=True)


def violating_seeds(
    final,
    spec: Spec,
    max_states: int = 200_000,
    screen=None,
    workers: int = 0,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Seeds of a finished sweep whose decoded history the checker
    rejects — the history oracle's counterpart of the models' latched
    violation flags. Overflowed
    histories are checked on their valid prefix (the buffer never
    wraps), so a reported seed is always a proven violation.

    ``screen=True`` runs the device-side first pass (oracle/screen.py)
    and decodes + checks only the suspect lanes — identical results by
    the screen's conservatism contract, at a fraction of the host cost
    (raises for a spec with no device screen); ``screen="auto"`` does
    the same but quietly degrades to checking every lane for unscreened
    specs; a callable screens with ``screen(final) -> bool[S]``.
    ``workers`` fans the checker over a process pool
    (``check_histories``).

    ``stats`` (a dict, mutated in place) receives
    ``{"checked": lanes handed to the checker, "budget_exceeded":
    lanes whose WGL search exhausted max_states}`` — undecided lanes
    are reported as non-violating (the checker is sound, not complete
    under a finite budget), so callers wanting the honest picture
    surface this count next to the seed list."""
    from .history import decode_lanes, decode_sweep

    if screen == "auto":
        from .screen import screen_for

        screen = screen_for(spec) is not None
    if screen is None or screen is False:
        hists = decode_sweep(final)
    else:
        from .screen import screen_sweep

        mask = (
            screen(final)
            if callable(screen)
            else screen_sweep(final, spec)
        )
        hists = decode_lanes(final, np.nonzero(host(mask))[0])
    results = check_histories(
        hists, spec, max_states=max_states, workers=workers
    )
    if stats is not None:
        stats["checked"] = len(hists)
        stats["budget_exceeded"] = sum(
            1 for r in results if not r.decided
        )
    out = [h.seed for h, r in zip(hists, results) if not r.ok]
    return np.asarray(out, dtype=np.int64)
