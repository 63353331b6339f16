"""The etcd service state machine (madsim-etcd-client/src/service.rs).

Pure deterministic state: ``ServiceInner { revision, kv: BTreeMap, lease:
HashMap, watcher: EventBus }`` (service.rs:189-198) with full
put/get(prefix)/delete/txn(compare+ops, recursive)/compact, leases whose
TTLs tick down in simulated seconds, and elections built on prefix
watches. No I/O here — the server wraps this in a node (server.py).
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple

from ..futures import Future
from ..grpc.status import Status

MAX_REQUEST_SIZE = int(1.5 * 1024 * 1024)  # service.rs:36


def _b(x: "str | bytes") -> bytes:
    return x.encode() if isinstance(x, str) else bytes(x)


@dataclass
class KeyValue:
    """etcd mvccpb.KeyValue."""

    key: bytes
    value: bytes
    create_revision: int
    mod_revision: int
    version: int = 1
    lease: int = 0

    def key_str(self) -> str:
        return self.key.decode()

    def value_str(self) -> str:
        return self.value.decode()


class EventType(Enum):
    PUT = "put"
    DELETE = "delete"


@dataclass
class Event:
    type: EventType
    kv: KeyValue
    prev_kv: Optional[KeyValue] = None


# -- options (fluent mirrors of etcd-client's *Options) ---------------------


@dataclass
class PutOptions:
    lease: int = 0
    prev_kv: bool = False

    def with_lease(self, lease: int) -> "PutOptions":
        self.lease = lease
        return self

    def with_prev_key(self) -> "PutOptions":
        self.prev_kv = True
        return self


@dataclass
class GetOptions:
    prefix: bool = False
    range_end: Optional[bytes] = None
    limit: int = 0
    revision: int = 0
    count_only: bool = False
    keys_only: bool = False
    #: etcd's from-key convention (range_end = "\0"): every key >= key
    from_key: bool = False

    def with_prefix(self) -> "GetOptions":
        self.prefix = True
        return self

    def with_range(self, end: "str | bytes") -> "GetOptions":
        self.range_end = _b(end)
        return self

    def with_limit(self, n: int) -> "GetOptions":
        self.limit = n
        return self

    def with_count_only(self) -> "GetOptions":
        self.count_only = True
        return self

    def with_keys_only(self) -> "GetOptions":
        self.keys_only = True
        return self


@dataclass
class DeleteOptions:
    prefix: bool = False
    range_end: Optional[bytes] = None
    prev_kv: bool = False
    #: etcd's from-key convention (range_end = "\0"): every key >= key
    from_key: bool = False

    def with_prefix(self) -> "DeleteOptions":
        self.prefix = True
        return self

    def with_range(self, end: "str | bytes") -> "DeleteOptions":
        self.range_end = _b(end)
        return self

    def with_prev_key(self) -> "DeleteOptions":
        self.prev_kv = True
        return self


class CompareOp(Enum):
    EQUAL = "="
    GREATER = ">"
    LESS = "<"
    NOT_EQUAL = "!="


@dataclass
class Compare:
    """Txn guard: compare a key's value/revision/version/lease.

    With ``range_end`` (or ``from_key``) set this is a RANGE compare
    (etcd >= 3.3): the predicate must hold for EVERY key in the range;
    an empty range is evaluated against the missing-key defaults (so the
    "no key in range exists" idiom — version == 0 — holds vacuously)."""

    key: bytes
    target: str  # "value" | "version" | "create_revision" | "mod_revision" | "lease"
    op: CompareOp
    operand: Any
    range_end: Optional[bytes] = None
    from_key: bool = False

    @staticmethod
    def value(key: "str | bytes", op: CompareOp, v: "str | bytes") -> "Compare":
        return Compare(_b(key), "value", op, _b(v))

    @staticmethod
    def version(key: "str | bytes", op: CompareOp, v: int) -> "Compare":
        return Compare(_b(key), "version", op, v)

    @staticmethod
    def create_revision(key: "str | bytes", op: CompareOp, v: int) -> "Compare":
        return Compare(_b(key), "create_revision", op, v)

    @staticmethod
    def mod_revision(key: "str | bytes", op: CompareOp, v: int) -> "Compare":
        return Compare(_b(key), "mod_revision", op, v)

    @staticmethod
    def lease(key: "str | bytes", op: CompareOp, v: int) -> "Compare":
        return Compare(_b(key), "lease", op, v)


@dataclass
class TxnOp:
    """One op inside a txn branch (put/get/delete/nested txn)."""

    kind: str
    args: Tuple = ()

    @staticmethod
    def put(key: "str | bytes", value: "str | bytes",
            options: Optional[PutOptions] = None) -> "TxnOp":
        return TxnOp("put", (_b(key), _b(value), options or PutOptions()))

    @staticmethod
    def get(key: "str | bytes", options: Optional[GetOptions] = None) -> "TxnOp":
        return TxnOp("get", (_b(key), options or GetOptions()))

    @staticmethod
    def delete(key: "str | bytes", options: Optional[DeleteOptions] = None) -> "TxnOp":
        return TxnOp("delete", (_b(key), options or DeleteOptions()))

    @staticmethod
    def txn(txn: "Txn") -> "TxnOp":
        return TxnOp("txn", (txn,))


@dataclass
class Txn:
    """compare-and-ops transaction (recursive — service.rs txn handling)."""

    compares: List[Compare] = field(default_factory=list)
    success: List[TxnOp] = field(default_factory=list)
    failure: List[TxnOp] = field(default_factory=list)

    def when(self, compares: List[Compare]) -> "Txn":
        self.compares = list(compares)
        return self

    def and_then(self, ops: List[TxnOp]) -> "Txn":
        self.success = list(ops)
        return self

    def or_else(self, ops: List[TxnOp]) -> "Txn":
        self.failure = list(ops)
        return self


@dataclass
class Lease:
    id: int
    ttl: int  # granted TTL seconds
    remaining: int  # seconds until expiry (ticked down)
    keys: set = field(default_factory=set)


class EventBus:
    """Prefix-watch pub/sub (the reference's watcher EventBus).

    ``future_factory`` produces the one-shot wakeup cell watchers block on;
    the default is the sim Future, and real mode (real/etcd.py) swaps in
    ``asyncio`` futures so the same service runs on a real event loop."""

    def __init__(self) -> None:
        self._watchers: List[Tuple[bytes, bool, List[Event], List[Future]]] = []
        self.future_factory = Future

    def subscribe(self, key: bytes, prefix: bool) -> "Watcher":
        entry = (key, prefix, [], [])
        self._watchers.append(entry)
        return Watcher(self, entry)

    def publish(self, event: Event) -> None:
        for key, prefix, queue, futs in self._watchers:
            match = (
                event.kv.key.startswith(key) if prefix else event.kv.key == key
            )
            if match:
                queue.append(event)
                waiters, futs[:] = futs[:], []
                for f in waiters:
                    if not f.done():  # asyncio futures raise if cancelled
                        f.set_result(None)


class Watcher:
    def __init__(self, bus: EventBus, entry: Tuple):
        self._bus = bus
        self._entry = entry

    async def next(self) -> Event:
        _key, _prefix, queue, futs = self._entry
        while not queue:
            fut = self._bus.future_factory()
            futs.append(fut)
            await fut
        return queue.pop(0)

    def cancel(self) -> None:
        try:
            self._bus._watchers.remove(self._entry)
        except ValueError:
            pass


class EtcdService:
    """``ServiceInner`` (service.rs:189-198) — the whole etcd state."""

    def __init__(self) -> None:
        self.revision = 0
        self.kv: Dict[bytes, KeyValue] = {}
        self.leases: Dict[int, Lease] = {}
        self.bus = EventBus()
        self._next_lease_id = 0x70000000

    # -- kv ----------------------------------------------------------------

    def _select(
        self,
        key: bytes,
        prefix: bool,
        range_end: Optional[bytes],
        from_key: bool = False,
    ) -> List[KeyValue]:
        if from_key:
            items = [kv for k, kv in self.kv.items() if k >= key]
        elif range_end is not None:
            items = [kv for k, kv in self.kv.items() if key <= k < range_end]
        elif prefix:
            items = [kv for k, kv in self.kv.items() if k.startswith(key)]
        else:
            items = [self.kv[key]] if key in self.kv else []
        return sorted(items, key=lambda kv: kv.key)

    def put(self, key: bytes, value: bytes, options: PutOptions) -> Tuple[int, Optional[KeyValue]]:
        if len(key) + len(value) > MAX_REQUEST_SIZE:
            raise Status.invalid_argument("etcdserver: request is too large")
        if options.lease and options.lease not in self.leases:
            raise Status.not_found("etcdserver: requested lease not found")
        self.revision += 1
        prev = self.kv.get(key)
        kv = KeyValue(
            key=key,
            value=value,
            create_revision=prev.create_revision if prev else self.revision,
            mod_revision=self.revision,
            version=prev.version + 1 if prev else 1,
            lease=options.lease,
        )
        self.kv[key] = kv
        if options.lease:
            self.leases[options.lease].keys.add(key)
        if prev and prev.lease and prev.lease != options.lease:
            lease = self.leases.get(prev.lease)
            if lease:
                lease.keys.discard(key)
        self.bus.publish(Event(EventType.PUT, kv, prev))
        return self.revision, prev if options.prev_kv else None

    def get(self, key: bytes, options: GetOptions) -> Tuple[int, List[KeyValue], int]:
        items = self._select(
            key, options.prefix, options.range_end, options.from_key
        )
        count = len(items)
        if options.limit:
            items = items[: options.limit]
        if options.count_only:
            items = []
        if options.keys_only:
            items = [
                KeyValue(kv.key, b"", kv.create_revision, kv.mod_revision,
                         kv.version, kv.lease)
                for kv in items
            ]
        return self.revision, items, count

    def delete(self, key: bytes, options: DeleteOptions) -> Tuple[int, int, List[KeyValue]]:
        items = self._select(
            key, options.prefix, options.range_end, options.from_key
        )
        if items:
            self.revision += 1
        for kv in items:
            del self.kv[kv.key]
            if kv.lease:
                lease = self.leases.get(kv.lease)
                if lease:
                    lease.keys.discard(kv.key)
            tomb = KeyValue(kv.key, b"", kv.create_revision, self.revision, 0, 0)
            self.bus.publish(Event(EventType.DELETE, tomb, kv))
        return self.revision, len(items), items if options.prev_kv else []

    def txn(self, txn: Txn) -> Tuple[int, bool, List[Any]]:
        succeeded = all(self._check(c) for c in txn.compares)
        results = [
            self._apply(op) for op in (txn.success if succeeded else txn.failure)
        ]
        return self.revision, succeeded, results

    def _check(self, c: Compare) -> bool:
        if c.range_end is not None or c.from_key:
            # range compare: must hold for every key in the range; empty
            # range -> evaluate once against missing-key defaults
            items = self._select(c.key, False, c.range_end, c.from_key)
            if not items:
                return self._check_one(None, c)
            return all(self._check_one(kv, c) for kv in items)
        return self._check_one(self.kv.get(c.key), c)

    def _check_one(self, kv: Optional[KeyValue], c: Compare) -> bool:
        if c.target == "value":
            actual: Any = kv.value if kv else b""
        elif kv is None:
            actual = 0
        else:
            actual = getattr(kv, c.target)
        op = c.op
        if op is CompareOp.EQUAL:
            return actual == c.operand
        if op is CompareOp.NOT_EQUAL:
            return actual != c.operand
        if op is CompareOp.GREATER:
            return actual > c.operand
        return actual < c.operand

    def _apply(self, op: TxnOp) -> Tuple[str, Any]:
        if op.kind == "put":
            key, value, options = op.args
            rev, prev = self.put(key, value, options)
            return ("put", (rev, prev))
        if op.kind == "get":
            key, options = op.args
            return ("get", self.get(key, options))
        if op.kind == "delete":
            key, options = op.args
            return ("delete", self.delete(key, options))
        return ("txn", self.txn(op.args[0]))

    def compact(self, revision: int) -> int:
        if revision > self.revision:
            raise Status.out_of_range(
                "etcdserver: mvcc: required revision is a future revision"
            )
        return self.revision

    # -- lease (service.rs:27-33,466-485) ----------------------------------

    def lease_grant(self, ttl: int, lease_id: int = 0) -> Tuple[int, int]:
        if lease_id == 0:
            self._next_lease_id += 1
            lease_id = self._next_lease_id
        if lease_id in self.leases:
            raise Status.failed_precondition("etcdserver: lease already exists")
        self.leases[lease_id] = Lease(id=lease_id, ttl=ttl, remaining=ttl)
        return lease_id, ttl

    def lease_revoke(self, lease_id: int) -> None:
        lease = self.leases.pop(lease_id, None)
        if lease is None:
            raise Status.not_found("etcdserver: requested lease not found")
        for key in sorted(lease.keys):
            self.delete(key, DeleteOptions())

    def lease_keep_alive(self, lease_id: int) -> Tuple[int, int]:
        lease = self.leases.get(lease_id)
        if lease is None:
            raise Status.not_found("etcdserver: requested lease not found")
        lease.remaining = lease.ttl
        return lease_id, lease.ttl

    def lease_time_to_live(self, lease_id: int) -> Tuple[int, int, int, List[bytes]]:
        lease = self.leases.get(lease_id)
        if lease is None:
            raise Status.not_found("etcdserver: requested lease not found")
        return lease_id, lease.remaining, lease.ttl, sorted(lease.keys)

    def lease_leases(self) -> List[int]:
        return sorted(self.leases)

    def tick(self) -> None:
        """One simulated second: expire leases (the reference's per-second
        tick task, service.rs:27-33)."""
        expired = []
        for lease in self.leases.values():
            lease.remaining -= 1
            if lease.remaining < 0:
                expired.append(lease.id)
        for lid in expired:
            self.lease_revoke(lid)

    # -- election (service.rs:487-583) --------------------------------------

    def election_key(self, name: bytes, lease_id: int) -> bytes:
        return name + b"/" + format(lease_id, "x").encode()

    def campaign_try(self, name: bytes, value: bytes, lease_id: int) -> Optional[bytes]:
        """Write our candidacy key; return the key if we are now leader
        (lowest create_revision under the election prefix), else None."""
        if lease_id not in self.leases:
            raise Status.not_found("etcdserver: requested lease not found")
        key = self.election_key(name, lease_id)
        if key not in self.kv:
            self.put(key, value, PutOptions(lease=lease_id))
        leader = self.election_leader(name)
        return key if leader is not None and leader.key == key else None

    def election_leader(self, name: bytes) -> Optional[KeyValue]:
        _rev, items, _n = self.get(name + b"/", GetOptions(prefix=True))
        if not items:
            return None
        return min(items, key=lambda kv: kv.create_revision)

    def proclaim(self, key: bytes, value: bytes) -> None:
        kv = self.kv.get(key)
        if kv is None:
            raise Status.failed_precondition("election: session expired")
        self.put(key, value, PutOptions(lease=kv.lease))

    def resign(self, key: bytes) -> None:
        self.delete(key, DeleteOptions())

    # -- snapshot (dump/load — service.rs:160-163) --------------------------

    def dump(self) -> str:
        def enc(b: bytes) -> str:
            return base64.b64encode(b).decode()

        return json.dumps(
            {
                "revision": self.revision,
                "next_lease_id": self._next_lease_id,
                "kv": [
                    {
                        "key": enc(kv.key),
                        "value": enc(kv.value),
                        "create_revision": kv.create_revision,
                        "mod_revision": kv.mod_revision,
                        "version": kv.version,
                        "lease": kv.lease,
                    }
                    for kv in sorted(self.kv.values(), key=lambda kv: kv.key)
                ],
                "leases": [
                    {
                        "id": l.id,
                        "ttl": l.ttl,
                        "remaining": l.remaining,
                        "keys": [enc(k) for k in sorted(l.keys)],
                    }
                    for l in sorted(self.leases.values(), key=lambda l: l.id)
                ],
            },
            indent=2,
        )

    def load(self, dump: str) -> None:
        def dec(s: str) -> bytes:
            return base64.b64decode(s)

        data = json.loads(dump)
        self.revision = data["revision"]
        self._next_lease_id = data["next_lease_id"]
        self.kv = {
            dec(e["key"]): KeyValue(
                dec(e["key"]), dec(e["value"]), e["create_revision"],
                e["mod_revision"], e["version"], e["lease"]
            )
            for e in data["kv"]
        }
        self.leases = {
            e["id"]: Lease(
                id=e["id"], ttl=e["ttl"], remaining=e["remaining"],
                keys={dec(k) for k in e["keys"]},
            )
            for e in data["leases"]
        }
