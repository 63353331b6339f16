"""Real-mode etcd twin: the same client API and server state machine over
real TCP.

The reference's madsim-etcd-client compiles to the *real* etcd-client crate
without ``--cfg madsim`` (madsim-etcd-client/src/lib.rs) — sim and
production share one API.  Python has no production etcd server to link
against in this image, so real mode here pairs the unchanged client surface
with the framework's own EtcdService state machine served over real sockets
(the shape of etcd's own integration harness): every request is one framed
TCP exchange, watches/observe/campaign hold their stream open, leases tick
on wall-clock seconds.

    from madsim_tpu_torch.real import etcd

    # server (own task / process)
    await etcd.Server.builder().serve(("127.0.0.1", 2379))
    # client
    client = await etcd.Client.connect("127.0.0.1:2379")
    await client.put("k", "v")

Wire safety: the restricted codec only materializes the option/data classes
registered below — a hostile peer cannot execute code.
"""

from __future__ import annotations

import asyncio
import random as _pyrandom
from typing import Any

from ..etcd.client import (
    Client as _SimClient,
    ConnectOptions,
    LeaderKey,
)
from ..etcd.server import SimServer as _SimServer, SimServerBuilder as _SimServerBuilder
from ..etcd.service import (
    Compare,
    CompareOp,
    DeleteOptions,
    EtcdService,
    Event,
    EventType,
    GetOptions,
    KeyValue,
    PutOptions,
    Txn,
    TxnOp,
)
from ..grpc.status import Code, Status
from . import codec, stream
from . import time as rtime
from .runtime import spawn

# the wire vocabulary of the etcd protocol — explicit, like the serde
# derives on the reference's request/response types
for _cls in (
    PutOptions,
    GetOptions,
    DeleteOptions,
    Compare,
    CompareOp,
    TxnOp,
    Txn,
    KeyValue,
    Event,
    EventType,
    Status,
    Code,
):
    codec.register(_cls)


def _asyncio_future() -> "asyncio.Future":
    return asyncio.get_running_loop().create_future()


class Server(_SimServer):
    """The EtcdService dispatcher on a real listener + wall-clock ticks.

    Serving rides the shared core (``madsim_tpu_torch/serve/``): the pull-
    style ``_serve_conn(tx, rx)`` dispatcher is unchanged — a
    ``ChannelAdapter`` recreates the pipe surface per connection while
    the core owns sockets, framing, backpressure, and metrics. (The
    grpcio wire tier, ``etcd/wire.py``, keeps its own HTTP/2 accept
    loop — grpc.aio owns it; see docs/wire.md.)
    """

    _spawn = staticmethod(spawn)
    _sleep = staticmethod(rtime.sleep)
    _rand01 = staticmethod(_pyrandom.random)
    _uniform = staticmethod(_pyrandom.uniform)

    @staticmethod
    async def _bind(addr: "str | tuple") -> Any:
        return await stream.StreamListener.bind(addr)

    async def serve(self, addr: "str | tuple") -> None:
        from ..serve import AsyncWireServer, ChannelAdapter

        # watchers must block on asyncio futures, not sim futures
        self.service.bus.future_factory = _asyncio_future
        adapter = ChannelAdapter(self._serve_conn, codec, name="etcd")
        self._core = AsyncWireServer(adapter, telemetry=self.telemetry)
        self.bound_addr = await self._core.start(addr)
        tick = spawn(self._tick_loop(), name="etcd-tick")
        try:
            await self._core._stopped.wait()
        finally:
            self._core._teardown()
            tick.abort()

    def close(self) -> None:
        core = getattr(self, "_core", None)
        if core is not None:
            core.close()

    @staticmethod
    def builder() -> "ServerBuilder":
        return ServerBuilder()


class LegacyServer(Server):
    """The pre-core accept loop (``StreamListener.accept1`` + one task
    per connection) — the A/B baseline for parity gates; deprecated for
    serving."""

    async def serve(self, addr: "str | tuple") -> None:
        self.service.bus.future_factory = _asyncio_future
        await _SimServer.serve(self, addr)


class ServerBuilder(_SimServerBuilder):
    _server_cls = Server


class Client(_SimClient):
    """The etcd client surface dialing real framed-TCP connections."""

    @staticmethod
    def _randint(n: int) -> int:
        return _pyrandom.randrange(n)  # real mode: real randomness

    async def _open(self):
        try:
            return await stream.connect(self._pick())
        except (ConnectionError, OSError) as e:
            raise Status.unavailable(f"etcd transport error: {e}") from None


__all__ = [
    "Client",
    "Compare",
    "CompareOp",
    "ConnectOptions",
    "DeleteOptions",
    "EtcdService",
    "Event",
    "EventType",
    "GetOptions",
    "KeyValue",
    "LeaderKey",
    "LegacyServer",
    "PutOptions",
    "Server",
    "ServerBuilder",
    "Txn",
    "TxnOp",
]
