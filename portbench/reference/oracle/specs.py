# The benchmark's plain reference: a frozen copy of madsim_tpu_torch/oracle/specs.py, run on the CPU.
# A change to the program's semantics reaches it only through a change to the benchmark.
"""Sequential specifications the linearizability checker runs against (the
port's copy of ``madsim_tpu/oracle/specs.py``; numpy-free host code).

A spec answers one question: *is this operation's observed result legal
as the next atomic step of the datatype?* The checker (oracle/check.py)
searches over linearization orders; the spec supplies the datatype's
sequential semantics through three methods:

- ``init() -> state`` — the initial abstract state. States must be
  **hashable** (the WGL search memoizes on ``(linearized-set, state)``).
- ``apply(state, op) -> (ok, state2)`` — attempt ``op`` as the next
  atomic step. For a completed op, ``ok`` demands the observed result
  matches; an open op (no completion recorded) has no observation to
  contradict, so ``ok`` is True and only the state effect applies.
- ``partition_of(op) -> key`` — linearizability is compositional over
  independent objects (the Herlihy–Wing locality theorem), so the
  checker verifies each partition's subhistory independently — the
  difference between exponential-in-history and exponential-in-
  per-key-contention.

``structural(ops)`` is an optional pre-pass for invariants that are
per-client and order-based rather than value-based (kafka's
committed-offset monotonicity) — cheap, and failures there skip the
search entirely.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .history import OP_DEL, OP_GET, OP_PUT, Op

ABSENT = -1  # the value-column encoding of "key not present"


class Spec:
    """Base sequential spec; subclasses override the three methods.

    ``name`` is identity, not decoration: the device-side screen
    (oracle/screen.py) dispatches its conservative first pass on it, so
    a subclass that reuses a bundled name inherits that screen's
    conservatism assumptions — a spec with *stricter* semantics than
    its namesake must pick a fresh name (and go unscreened) rather than
    risk the screen clearing seeds its checker would reject."""

    name = "spec"

    def init(self):
        raise NotImplementedError

    def apply(self, state, op: Op):
        raise NotImplementedError

    def partition_of(self, op: Op) -> int:
        return 0

    def structural(self, ops: Sequence[Op]) -> Optional[Tuple[int, str]]:
        """Order-based pre-check; return ``(op index, reason)`` on breach."""
        return None

    def partition(self, ops: Sequence[Op]) -> Dict[int, List[Tuple[int, Op]]]:
        """Group ops by partition key, keeping each op's global index."""
        parts: Dict[int, List[Tuple[int, Op]]] = {}
        for i, op in enumerate(ops):
            parts.setdefault(self.partition_of(op), []).append((i, op))
        return parts


class KVSpec(Spec):
    """A map of independent int registers — the etcd KV sequential spec.

    Per-key state is the register value (``ABSENT`` when unset). PUT
    writes, GET must observe exactly the current value, DEL (the etcd
    model's internal lease-expiry deletions, recorded as server ops with
    invoke == complete) unsets. One key = one partition, so the search
    only ever weighs genuinely-concurrent ops on the same key.
    """

    name = "kv"

    def init(self):
        return ABSENT

    def apply(self, state, op: Op):
        if op.op == OP_PUT:
            return True, op.inp
        if op.op == OP_DEL:
            return True, ABSENT
        if op.op == OP_GET:
            ok = (not op.complete) or op.out == state
            return ok, state
        return False, state

    def partition_of(self, op: Op) -> int:
        return op.key
