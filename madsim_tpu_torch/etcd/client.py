"""etcd client handles (madsim-etcd-client/src/sim.rs:33-77).

``Client.connect([addr], options)`` + ``{kv, lease, election, maintenance,
watch}_client()`` views; every operation is one ``connect1`` exchange with
the SimServer (server.rs:104-167). Response objects mirror the etcd-client
Rust API shape (``resp.kvs()``, ``resp.header().revision()``, …).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

from .. import rand as msrand
from ..grpc.status import Status
from ..net.endpoint import connect1_ephemeral, exchange1
from .service import (
    DeleteOptions,
    Event,
    GetOptions,
    KeyValue,
    PutOptions,
    Txn,
    _b,
)


@dataclass
class ResponseHeader:
    _revision: int

    def revision(self) -> int:
        return self._revision


@dataclass
class PutResponse:
    _header: ResponseHeader
    _prev_kv: Optional[KeyValue]

    def header(self) -> ResponseHeader:
        return self._header

    def prev_key(self) -> Optional[KeyValue]:
        return self._prev_kv


@dataclass
class GetResponse:
    _header: ResponseHeader
    _kvs: List[KeyValue]
    _count: int

    def header(self) -> ResponseHeader:
        return self._header

    def kvs(self) -> List[KeyValue]:
        return self._kvs

    def count(self) -> int:
        return self._count


@dataclass
class DeleteResponse:
    _header: ResponseHeader
    _deleted: int
    _prev_kvs: List[KeyValue]

    def header(self) -> ResponseHeader:
        return self._header

    def deleted(self) -> int:
        return self._deleted

    def prev_kvs(self) -> List[KeyValue]:
        return self._prev_kvs


@dataclass
class TxnResponse:
    _header: ResponseHeader
    _succeeded: bool
    _responses: List[Any]

    def header(self) -> ResponseHeader:
        return self._header

    def succeeded(self) -> bool:
        return self._succeeded

    def op_responses(self) -> List[Any]:
        return self._responses


@dataclass
class LeaseGrantResponse:
    _id: int
    _ttl: int

    def id(self) -> int:
        return self._id

    def ttl(self) -> int:
        return self._ttl


@dataclass
class LeaseKeepAliveResponse:
    _id: int
    _ttl: int

    def id(self) -> int:
        return self._id

    def ttl(self) -> int:
        return self._ttl


@dataclass
class LeaseTimeToLiveResponse:
    _id: int
    _ttl: int
    _granted_ttl: int
    _keys: List[bytes]

    def id(self) -> int:
        return self._id

    def ttl(self) -> int:
        return self._ttl

    def granted_ttl(self) -> int:
        return self._granted_ttl

    def keys(self) -> List[bytes]:
        return self._keys


@dataclass
class LeaderKey:
    _name: bytes
    _key: bytes
    _rev: int
    _lease: int

    def name(self) -> bytes:
        return self._name

    def key(self) -> bytes:
        return self._key

    def rev(self) -> int:
        return self._rev

    def lease(self) -> int:
        return self._lease


@dataclass
class CampaignResponse:
    _leader: LeaderKey

    def leader(self) -> LeaderKey:
        return self._leader


@dataclass
class LeaderResponse:
    _kv: Optional[KeyValue]

    def kv(self) -> Optional[KeyValue]:
        return self._kv


@dataclass
class StatusResponse:
    _revision: int
    _num_keys: int

    def revision(self) -> int:
        return self._revision


class ConnectOptions:
    """Accepted for API parity (auth/timeouts are sim-irrelevant)."""

    def __init__(self) -> None:
        pass

    def with_user(self, _name: str, _password: str) -> "ConnectOptions":
        return self

    def with_timeout(self, _seconds: float) -> "ConnectOptions":
        return self

    def with_connect_timeout(self, _seconds: float) -> "ConnectOptions":
        return self


class Client:
    """The top-level handle (sim.rs:33-77)."""

    def __init__(self, endpoints: List[str]):
        self._endpoints = endpoints

    @classmethod
    async def connect(
        cls,
        endpoints: "str | Sequence[str]",
        options: Optional[ConnectOptions] = None,
    ) -> "Client":
        if isinstance(endpoints, str):
            endpoints = [endpoints]
        return cls(list(endpoints))

    # -- plumbing ----------------------------------------------------------

    @staticmethod
    def _randint(n: int) -> int:
        """Endpoint-balance draw — sim RNG; real/etcd.py overrides."""
        return msrand.gen_range(0, n)

    def _pick(self) -> str:
        eps = self._endpoints
        return eps[self._randint(len(eps))] if len(eps) > 1 else eps[0]

    async def _open(self):
        return await connect1_ephemeral(self._pick())

    async def _call(self, req: tuple) -> Any:
        tx, rx = await self._open()
        try:
            rsp = await exchange1(tx, rx, req)
        except (BrokenPipeError, ConnectionResetError) as e:
            raise Status.unavailable(f"etcd transport error: {e}") from None
        if rsp is None:
            raise Status.unavailable("etcd connection closed")
        kind, payload = rsp
        if kind == "err":
            raise payload
        return payload

    async def _stream(self, req: tuple) -> Tuple[Any, Any]:
        tx, rx = await self._open()
        await tx.send(req)
        return tx, rx

    # -- sub-clients -------------------------------------------------------

    def kv_client(self) -> "KvClient":
        return KvClient(self)

    def lease_client(self) -> "LeaseClient":
        return LeaseClient(self)

    def election_client(self) -> "ElectionClient":
        return ElectionClient(self)

    def maintenance_client(self) -> "MaintenanceClient":
        return MaintenanceClient(self)

    def watch_client(self) -> "WatchClient":
        return WatchClient(self)

    # convenience passthroughs (etcd-client has these on Client too)

    async def put(self, key, value, options: Optional[PutOptions] = None) -> PutResponse:
        return await self.kv_client().put(key, value, options)

    async def get(self, key, options: Optional[GetOptions] = None) -> GetResponse:
        return await self.kv_client().get(key, options)

    async def delete(self, key, options: Optional[DeleteOptions] = None) -> DeleteResponse:
        return await self.kv_client().delete(key, options)

    async def txn(self, txn: Txn) -> TxnResponse:
        return await self.kv_client().txn(txn)

    # snapshot-restore (sim.rs:70-77)

    async def dump(self) -> str:
        return await self._call(("dump",))

    async def load(self, dump: str) -> None:
        await self._call(("load", dump))


class KvClient:
    def __init__(self, client: Client):
        self._c = client

    async def put(self, key, value, options: Optional[PutOptions] = None) -> PutResponse:
        rev, prev = await self._c._call(("put", _b(key), _b(value), options))
        return PutResponse(ResponseHeader(rev), prev)

    async def get(self, key, options: Optional[GetOptions] = None) -> GetResponse:
        rev, kvs, count = await self._c._call(("get", _b(key), options))
        return GetResponse(ResponseHeader(rev), kvs, count)

    async def delete(self, key, options: Optional[DeleteOptions] = None) -> DeleteResponse:
        rev, deleted, prev = await self._c._call(("delete", _b(key), options))
        return DeleteResponse(ResponseHeader(rev), deleted, prev)

    async def txn(self, txn: Txn) -> TxnResponse:
        rev, ok, results = await self._c._call(("txn", txn))
        return TxnResponse(ResponseHeader(rev), ok, results)

    async def compact(self, revision: int) -> None:
        await self._c._call(("compact", revision))


class LeaseClient:
    def __init__(self, client: Client):
        self._c = client

    async def grant(self, ttl: int, lease_id: int = 0) -> LeaseGrantResponse:
        lid, ttl = await self._c._call(("lease_grant", ttl, lease_id))
        return LeaseGrantResponse(lid, ttl)

    async def revoke(self, lease_id: int) -> None:
        await self._c._call(("lease_revoke", lease_id))

    async def keep_alive(self, lease_id: int) -> LeaseKeepAliveResponse:
        lid, ttl = await self._c._call(("lease_keep_alive", lease_id))
        return LeaseKeepAliveResponse(lid, ttl)

    async def time_to_live(self, lease_id: int) -> LeaseTimeToLiveResponse:
        lid, ttl, granted, keys = await self._c._call(("lease_time_to_live", lease_id))
        return LeaseTimeToLiveResponse(lid, ttl, granted, keys)

    async def leases(self) -> List[int]:
        return await self._c._call(("lease_leases",))


class ElectionClient:
    """campaign/proclaim/leader/observe/resign (service.rs:487-583)."""

    def __init__(self, client: Client):
        self._c = client

    async def campaign(self, name, value, lease_id: int) -> CampaignResponse:
        tx, rx = await self._c._stream(("campaign", _b(name), _b(value), lease_id))
        try:
            rsp = await rx.recv()
        except ConnectionResetError as e:
            raise Status.unavailable(str(e)) from None
        finally:
            tx.close()
            rx.close()  # exchange complete; frees the real-mode socket
        if rsp is None:
            raise Status.unavailable("etcd connection closed")
        kind, payload = rsp
        if kind == "err":
            raise payload
        name_, key, rev, lease = payload
        return CampaignResponse(LeaderKey(name_, key, rev, lease))

    async def proclaim(self, value, leader: LeaderKey) -> None:
        await self._c._call(("proclaim", leader.key(), _b(value)))

    async def leader(self, name) -> LeaderResponse:
        kv = await self._c._call(("leader", _b(name)))
        return LeaderResponse(kv)

    async def observe(self, name) -> "ObserveStream":
        tx, rx = await self._c._stream(("observe", _b(name)))
        return ObserveStream(tx, rx)

    async def resign(self, leader: LeaderKey) -> None:
        await self._c._call(("resign", leader.key()))


class ObserveStream:
    """Async stream of leader KeyValues."""

    def __init__(self, tx: Any, rx: Any):
        self._tx = tx
        self._rx = rx

    async def next(self) -> Optional[KeyValue]:
        try:
            return await self._rx.recv()
        except ConnectionResetError:
            return None

    def __aiter__(self) -> "ObserveStream":
        return self

    async def __anext__(self) -> KeyValue:
        kv = await self.next()
        if kv is None:
            raise StopAsyncIteration
        return kv

    def cancel(self) -> None:
        # close both halves: closing the receiver makes the server's next
        # send raise BrokenPipeError, tearing down its observe loop
        self._tx.close()
        self._rx.close()


class WatchStream:
    """Async stream of watch Events."""

    def __init__(self, tx: Any, rx: Any):
        self._tx = tx
        self._rx = rx

    async def next(self) -> Optional[Event]:
        try:
            return await self._rx.recv()
        except ConnectionResetError:
            return None

    def __aiter__(self) -> "WatchStream":
        return self

    async def __anext__(self) -> Event:
        ev = await self.next()
        if ev is None:
            raise StopAsyncIteration
        return ev

    def cancel(self) -> None:
        # close both halves so the server's watch loop tears down on its
        # next send instead of queueing events forever
        self._tx.close()
        self._rx.close()


class WatchClient:
    def __init__(self, client: Client):
        self._c = client

    async def watch(self, key, prefix: bool = False) -> WatchStream:
        tx, rx = await self._c._stream(("watch", _b(key), prefix))
        try:
            head = await rx.recv()
            if head is None:
                raise Status.unavailable("etcd connection closed")
            kind, payload = head
            if kind == "err":
                raise payload
        except BaseException:
            tx.close()
            rx.close()  # failed exchange must not leak the real-mode socket
            raise
        return WatchStream(tx, rx)


class MaintenanceClient:
    def __init__(self, client: Client):
        self._c = client

    async def status(self) -> StatusResponse:
        rev, nkeys = await self._c._call(("status",))
        return StatusResponse(rev, nkeys)
