"""The etcd sim server node (madsim-etcd-client/src/server.rs).

``SimServer.builder().timeout_rate(p).serve(addr)`` binds an Endpoint and
answers one request enum per ``connect1`` exchange (server.rs:104-167).
Streaming ops (watch, observe, blocking campaign) keep their connection
open. A per-simulated-second tick task drives lease expiry, and
``timeout_rate`` injects random 5-15 s delays followed by Unavailable
(service.rs:165-176).
"""

from __future__ import annotations

from typing import Any, Optional

from .. import rand as msrand
from .. import task as mstask
from .. import time as mstime
from ..grpc.status import Status
from ..net.endpoint import Endpoint as NetEndpoint
from .service import (
    DeleteOptions,
    EtcdService,
    GetOptions,
    PutOptions,
    Txn,
)


class SimServerBuilder:
    _server_cls: "type | None" = None  # real/etcd.py overrides

    def __init__(self) -> None:
        self._timeout_rate = 0.0
        self._service: Optional[EtcdService] = None
        self._telemetry = None

    def timeout_rate(self, rate: float) -> "SimServerBuilder":
        """Fraction of requests that hang 5-15 s then fail Unavailable
        (server.rs:20-25)."""
        self._timeout_rate = rate
        return self

    def telemetry(self, telemetry) -> "SimServerBuilder":
        """Attach an ``obs.Telemetry`` handle for wire-level metrics."""
        self._telemetry = telemetry
        return self

    def load(self, dump: str) -> "SimServerBuilder":
        """Start from a dumped snapshot (server.rs:27-31)."""
        svc = EtcdService()
        svc.load(dump)
        self._service = svc
        return self

    async def serve(self, addr: "str | tuple") -> None:
        server = (self._server_cls or SimServer)(
            self._service or EtcdService(), self._timeout_rate,
            telemetry=self._telemetry,
        )
        await server.serve(addr)


class SimServer:
    @staticmethod
    def builder() -> SimServerBuilder:
        return SimServerBuilder()

    # executor bindings as class attributes so the real-mode twin
    # (real/etcd.py) can rebind them to asyncio + real randomness while
    # reusing the whole request dispatcher — the sim/std split of
    # madsim-etcd-client/src/lib.rs
    _spawn = staticmethod(mstask.spawn)
    _sleep = staticmethod(mstime.sleep)
    _rand01 = staticmethod(msrand.random)
    _uniform = staticmethod(msrand.uniform)

    @staticmethod
    async def _bind(addr: "str | tuple") -> Any:
        return await NetEndpoint.bind(addr)

    def __init__(self, service: EtcdService, timeout_rate: float = 0.0,
                 telemetry=None):
        self.service = service
        self.timeout_rate = timeout_rate
        self.telemetry = telemetry
        #: set once the listener is bound (port-0 discovery, real mode)
        self.bound_addr: "Optional[tuple]" = None

    async def serve(self, addr: "str | tuple") -> None:
        ep = await self._bind(addr)
        local = getattr(ep, "local_addr", None)
        self.bound_addr = local() if callable(local) else None
        self._spawn(self._tick_loop(), name="etcd-tick")
        while True:
            tx, rx, _src = await ep.accept1()
            self._spawn(self._serve_conn(tx, rx), name="etcd-conn")

    async def _tick_loop(self) -> None:
        while True:
            await self._sleep(1.0)
            self.service.tick()

    async def _serve_conn(self, tx: Any, rx: Any) -> None:
        if self.telemetry is not None:
            self.telemetry.count(
                "etcd_connections_total", help="accepted connections"
            )
        try:
            req = await rx.recv()
            if req is None:
                return
            if self.timeout_rate > 0 and self._rand01() < self.timeout_rate:
                await self._sleep(self._uniform(5.0, 15.0))
                await tx.send(("err", Status.unavailable("etcdserver: request timed out")))
                return
            await self._handle(req, tx, rx)
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            tx.close()

    async def _handle(self, req: tuple, tx: Any, rx: Any) -> None:
        if self.telemetry is None:
            return await self._handle_op(req, tx, rx)
        import time as _walltime

        t0 = _walltime.perf_counter()
        op = str(req[0]) if req else "?"
        try:
            return await self._handle_op(req, tx, rx)
        finally:
            self.telemetry.count(
                "etcd_requests_total", help="requests served", op=op
            )
            self.telemetry.observe(
                "etcd_api_seconds", _walltime.perf_counter() - t0,
                help="per-op handling latency", op=op,
            )

    async def _handle_op(self, req: tuple, tx: Any, rx: Any) -> None:
        svc = self.service
        op = req[0]
        try:
            if op == "put":
                _, key, value, options = req
                rev, prev = svc.put(key, value, options or PutOptions())
                await tx.send(("ok", (rev, prev)))
            elif op == "get":
                _, key, options = req
                await tx.send(("ok", svc.get(key, options or GetOptions())))
            elif op == "delete":
                _, key, options = req
                await tx.send(("ok", svc.delete(key, options or DeleteOptions())))
            elif op == "txn":
                _, txn = req
                assert isinstance(txn, Txn)
                await tx.send(("ok", svc.txn(txn)))
            elif op == "compact":
                _, revision = req
                await tx.send(("ok", svc.compact(revision)))
            elif op == "lease_grant":
                _, ttl, lease_id = req
                await tx.send(("ok", svc.lease_grant(ttl, lease_id)))
            elif op == "lease_revoke":
                _, lease_id = req
                svc.lease_revoke(lease_id)
                await tx.send(("ok", None))
            elif op == "lease_keep_alive":
                _, lease_id = req
                await tx.send(("ok", svc.lease_keep_alive(lease_id)))
            elif op == "lease_time_to_live":
                _, lease_id = req
                await tx.send(("ok", svc.lease_time_to_live(lease_id)))
            elif op == "lease_leases":
                await tx.send(("ok", svc.lease_leases()))
            elif op == "campaign":
                # blocks until leadership (service.rs:487-527): retry on
                # every change under the election prefix
                _, name, value, lease_id = req
                while True:
                    key = svc.campaign_try(name, value, lease_id)
                    if key is not None:
                        kv = svc.kv[key]
                        await tx.send(("ok", (name, key, kv.create_revision, lease_id)))
                        break
                    watcher = svc.bus.subscribe(name + b"/", prefix=True)
                    try:
                        await watcher.next()
                    finally:
                        watcher.cancel()
            elif op == "proclaim":
                _, key, value = req
                svc.proclaim(key, value)
                await tx.send(("ok", None))
            elif op == "leader":
                _, name = req
                kv = svc.election_leader(name)
                if kv is None:
                    await tx.send(("err", Status.not_found("election: no leader")))
                else:
                    await tx.send(("ok", kv))
            elif op == "observe":
                # stream of leader kvs (service.rs:553-583)
                _, name = req
                watcher = svc.bus.subscribe(name + b"/", prefix=True)
                try:
                    leader = svc.election_leader(name)
                    if leader is not None:
                        await tx.send(leader)
                    while True:
                        await watcher.next()
                        leader = svc.election_leader(name)
                        if leader is not None:
                            await tx.send(leader)
                finally:
                    watcher.cancel()
            elif op == "resign":
                _, key = req
                svc.resign(key)
                await tx.send(("ok", None))
            elif op == "watch":
                _, key, prefix = req
                watcher = svc.bus.subscribe(key, prefix=prefix)
                try:
                    await tx.send(("ok", None))
                    while True:
                        event = await watcher.next()
                        await tx.send(event)
                finally:
                    watcher.cancel()
            elif op == "status":
                await tx.send(("ok", (svc.revision, len(svc.kv))))
            elif op == "dump":
                await tx.send(("ok", svc.dump()))
            elif op == "load":
                _, dump = req
                svc.load(dump)
                await tx.send(("ok", None))
            else:
                await tx.send(("err", Status.unimplemented(f"unknown op {op!r}")))
        except Status as st:
            await tx.send(("err", st))
