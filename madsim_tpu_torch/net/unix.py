"""Simulated Unix domain sockets — implemented, beating the reference's
stubs (madsim/src/sim/net/unix/{stream,datagram}.rs is all ``todo!()``).

Unix sockets are node-local IPC: paths live in a per-node namespace (like
the per-node fs), so two nodes can bind the same path and a connect never
crosses nodes. Streams reuse the reliable ``_Pipe`` machinery that backs
``connect1``/TCP — registered in NetSim's per-node pipe table, so a node
kill breaks live unix connections exactly like TCP ones — and datagrams
get a mailbox with the same rand-delay + latency timer delivery as UDP
(minus link faults: there is no link to clog inside one node).

Surface mirrors tokio's ``net::{UnixStream, UnixListener, UnixDatagram}``,
matching what the reference stubs declare.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, List, Optional, Tuple

from ..context import current_node
from ..futures import Future
from ..plugin import simulator
from ..task import NodeId
from .netsim import NetSim, PipeReceiver, PipeSender, _Pipe
from .tcp import TcpStream


def _netsim() -> NetSim:
    return simulator(NetSim)


def _here() -> NodeId:
    return current_node().id


class UnixStream(TcpStream):
    """Connected byte stream over a path (same read/write surface as the
    simulated TcpStream; addresses are paths)."""

    @staticmethod
    async def connect(path: str) -> "UnixStream":
        ns = _netsim()
        node = _here()
        await ns.rand_delay()
        listener = ns.unix_listeners.get((node, str(path)))
        if listener is None:
            raise ConnectionRefusedError(f"connection refused: {path!r}")
        c2s = _Pipe(ns, node, node)
        s2c = _Pipe(ns, node, node)
        ns._node_pipes.setdefault(node, []).extend((c2s, s2c))
        server_stream = UnixStream(
            PipeSender(s2c), PipeReceiver(c2s), str(path), ""
        )
        latency = ns.network.latency()
        ns.network.stat.msg_count += 1
        ns.time.add_timer(latency, lambda: listener._deliver(server_stream))
        return UnixStream(PipeSender(c2s), PipeReceiver(s2c), "", str(path))


class UnixListener:
    """Accepting socket bound to a node-local path."""

    def __init__(self, node: NodeId, path: str):
        self._node = node
        self._path = path
        self._pending: Deque[UnixStream] = deque()
        self._waiters: List[Future] = []
        self._closed = False
        self._broken = False

    @staticmethod
    async def bind(path: str) -> "UnixListener":
        ns = _netsim()
        node = _here()
        key = (node, str(path))
        if key in ns.unix_listeners or key in ns.unix_dgrams:
            raise OSError(f"address already in use: {path!r}")
        listener = UnixListener(node, str(path))
        ns.unix_listeners[key] = listener
        return listener

    def local_addr(self) -> str:
        return self._path

    def _deliver(self, stream: "UnixStream") -> None:
        if self._closed or self._broken:
            stream.close()
            return
        self._pending.append(stream)
        waiters, self._waiters = self._waiters, []
        for fut in waiters:
            fut.set_result(None)

    async def accept(self) -> Tuple["UnixStream", str]:
        while not self._pending:
            if self._closed or self._broken:
                raise ConnectionAbortedError("listener closed")
            fut: Future = Future()
            self._waiters.append(fut)
            await fut
        stream = self._pending.popleft()
        return stream, stream.peer_addr()

    def close(self) -> None:
        self._closed = True
        ns = _netsim()
        if ns.unix_listeners.get((self._node, self._path)) is self:
            del ns.unix_listeners[(self._node, self._path)]
        self.break_all()

    def break_all(self) -> None:
        """Node reset: drop pending connections, wake blocked accepts."""
        self._broken = True
        while self._pending:
            self._pending.popleft().close()
        waiters, self._waiters = self._waiters, []
        for fut in waiters:
            fut.set_result(None)

    def __enter__(self) -> "UnixListener":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class UnixDatagram:
    """Connectionless datagrams over node-local paths (lossless within a
    node; delivery still goes through the virtual-time timer so schedules
    stay randomized)."""

    def __init__(self, node: NodeId, path: Optional[str]):
        self._node = node
        self._path = path  # None = unbound (can send, cannot be addressed)
        self._mailbox: Deque[Tuple[bytes, str]] = deque()
        self._waiters: List[Future] = []
        self._peer: Optional[str] = None
        self._closed = False
        self._broken = False

    @staticmethod
    async def bind(path: str) -> "UnixDatagram":
        ns = _netsim()
        node = _here()
        key = (node, str(path))
        if key in ns.unix_dgrams or key in ns.unix_listeners:
            raise OSError(f"address already in use: {path!r}")
        sock = UnixDatagram(node, str(path))
        ns.unix_dgrams[key] = sock
        return sock

    @staticmethod
    def unbound() -> "UnixDatagram":
        return UnixDatagram(_here(), None)

    def local_addr(self) -> Optional[str]:
        return self._path

    def connect(self, path: str) -> None:
        """Set the default destination for ``send``/``recv``."""
        self._peer = str(path)

    async def send_to(self, data: bytes, path: str) -> int:
        ns = _netsim()
        if self._closed:
            raise OSError("socket closed")
        await ns.rand_delay()
        dst = ns.unix_dgrams.get((self._node, str(path)))
        if dst is None:
            # kernel semantics: unix datagrams to a missing path error out
            # (unlike lossy UDP)
            raise ConnectionRefusedError(f"no such socket: {path!r}")
        payload = (bytes(data), self._path or "")
        latency = ns.network.latency()
        ns.network.stat.msg_count += 1
        ns.time.add_timer(latency, lambda: dst._deliver(payload))
        return len(data)

    def _deliver(self, payload: Tuple[bytes, str]) -> None:
        if self._closed or self._broken:
            return
        self._mailbox.append(payload)
        waiters, self._waiters = self._waiters, []
        for fut in waiters:
            fut.set_result(None)

    async def recv_from(self) -> Tuple[bytes, str]:
        while not self._mailbox:
            if self._closed or self._broken:
                raise ConnectionResetError("socket closed")
            fut: Future = Future()
            self._waiters.append(fut)
            await fut
        return self._mailbox.popleft()

    async def send(self, data: bytes) -> int:
        if self._peer is None:
            raise OSError("not connected")
        return await self.send_to(data, self._peer)

    async def recv(self) -> bytes:
        data, _src = await self.recv_from()
        return data

    def close(self) -> None:
        self._closed = True
        ns = _netsim()
        if self._path is not None and (
            ns.unix_dgrams.get((self._node, self._path)) is self
        ):
            del ns.unix_dgrams[(self._node, self._path)]
        waiters, self._waiters = self._waiters, []
        for fut in waiters:
            fut.set_result(None)

    def __enter__(self) -> "UnixDatagram":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
