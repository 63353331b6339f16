# The benchmark's plain reference: a frozen copy of madsim_tpu_torch/oracle/check.py, run on the CPU.
# A change to the program's semantics reaches it only through a change to the benchmark.
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

from .history import History, Op
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
