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

from .history import OP_DEL, OP_ELECT, OP_FETCH, OP_GET, OP_PRODUCE, OP_PUT, Op

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


class LogSpec(Spec):
    """Per-partition ordered log — the kafka sequential spec.

    Per-partition state is the number of appended records. PRODUCE
    appends one record (retries are separate invokes and separate
    appends — the device broker does not dedupe); a completed
    FETCH(offset) that served ``out`` records requires ``offset + out``
    records to already exist — a broker serving records no linearized
    produce could have appended is the violation.

    ``structural`` adds committed-offset monotonicity: the device client
    only records a fetch completion when the response matched its
    position, so each consumer's completed fetches must advance its
    offset contiguously — ``offset[i+1] == offset[i] + served[i]`` in
    completion order, never backwards.
    """

    name = "log"

    def init(self):
        return 0

    def apply(self, state, op: Op):
        if op.op == OP_PRODUCE:
            return True, state + 1
        if op.op == OP_FETCH:
            ok = (not op.complete) or (op.inp + op.out <= state)
            return ok, state
        return False, state

    def partition_of(self, op: Op) -> int:
        return op.key

    def structural(self, ops: Sequence[Op]) -> Optional[Tuple[int, str]]:
        pos: Dict[Tuple[int, int], int] = {}  # (client, partition) -> offset
        done = [
            (op.complete_ns, i, op)
            for i, op in enumerate(ops)
            if op.op == OP_FETCH and op.complete
        ]
        for _, i, op in sorted(done):
            expect = pos.get((op.client, op.key), 0)
            if op.inp != expect:
                return i, (
                    f"consumer {op.client} offset broke contiguity on "
                    f"partition {op.key}: fetched at {op.inp}, committed "
                    f"offset was {expect}"
                )
            pos[(op.client, op.key)] = op.inp + op.out
        return None


class S3Spec(Spec):
    """Per-object last-writer-wins register — the S3 sequential spec
    (the one model that had none; ROADMAP item 4).

    S3's data plane is a flat namespace of whole-object registers:
    PutObject replaces the value atomically (multipart upload included —
    its parts become visible only at CompleteMultipartUpload, which is
    the single atomic write the history records), GetObject observes
    exactly the current value, DeleteObject unsets it and a subsequent
    GET must observe absence. Recorded with the KV op vocabulary
    (OP_PUT/OP_GET/OP_DEL) but under its own name: values are content
    *fingerprints* (a 63-bit digest of the object body), ``ABSENT``
    encodes both "404" and "never written". One object key = one
    partition (S3 promises nothing across keys).

    What distinguishes it from ``KVSpec`` semantically is the failure
    envelope the load rig leans on: a completed GET with ``out ==
    ABSENT`` after any successful PUT of that key is only legal if a
    DELETE (or nothing) linearizes between them — torn multipart
    visibility or a lost PUT under an fsync stall shows up as exactly
    that inconsistency.
    """

    name = "s3"

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


class ElectionSpec(Spec):
    """Raft election safety as a sequential spec: at most one leader per
    term.

    Election histories are invoke-only (an ``OP_ELECT`` row per won
    election, key = term, inp = winner node; no client observes a
    completion), and the WGL search treats open ops as *optional* —
    omittable — so the invariant lives entirely in ``structural``: two
    OP_ELECT rows for one term naming different nodes is the breach. The
    device raft model records these rows through its ``record`` hook, and
    a host run through ``HostRecorder``, so one spec checks both.
    """

    name = "election"

    def init(self):
        return ABSENT

    def apply(self, state, op: Op):
        # open ops carry no observation; the state tracks the term's
        # winner for completeness but structural() is the real check
        if op.op == OP_ELECT:
            return True, op.inp
        return False, state

    def partition_of(self, op: Op) -> int:
        return op.key  # the term

    def structural(self, ops: Sequence[Op]) -> Optional[Tuple[int, str]]:
        winner: Dict[int, int] = {}  # term -> node
        for i, op in enumerate(ops):
            if op.op != OP_ELECT:
                continue
            prev = winner.get(op.key)
            if prev is not None and prev != op.inp:
                return i, (
                    f"two leaders elected in term {op.key}: node {prev} "
                    f"and node {op.inp}"
                )
            winner[op.key] = op.inp
        return None
