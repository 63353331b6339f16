"""Endpoint: tag-matching messaging socket
(ref madsim/src/sim/net/endpoint.rs:13-363).

An Endpoint is the universal simulated socket: a mailbox of ``tag ->
messages`` with registered-recv oneshots + undelivered queues
(endpoint.rs:297-363), a bytes API (``send_to``/``recv_from``) plus a raw
payload API (``*_raw``, the Box<dyn Any> analogue) used by the other
simulators, and connection-oriented ``connect1``/``accept1`` built on
NetSim's reliable channels.  Built-in RPC lives in ``net.rpc`` and is
exposed as Endpoint methods (``call``/``add_rpc_handler``/...).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..context import current_node, current_handle
from ..futures import Future
from ..plugin import simulator
from ..task import NodeId
from .netsim import NetSim, PipeReceiver, PipeSender
from .network import UDP, Addr, parse_addr


class Mailbox:
    """tag -> (pending recv oneshots, undelivered messages)
    (ref ``Mailbox``, endpoint.rs:297-363)."""

    def __init__(self) -> None:
        self.registered: Dict[int, List[Future]] = {}
        self.undelivered: Dict[int, Deque[Tuple[Any, Addr]]] = {}

    def deliver(self, tag: int, payload: Any, src: Addr) -> None:
        waiters = self.registered.get(tag)
        while waiters:
            fut = waiters.pop(0)
            if not fut.done():
                fut.set_result((payload, src))
                return
        self.undelivered.setdefault(tag, deque()).append((payload, src))

    def recv(self, tag: int) -> "Future":
        fut: Future = Future()
        queue = self.undelivered.get(tag)
        if queue:
            payload, src = queue.popleft()
            if not queue:
                del self.undelivered[tag]
            fut.set_result((payload, src))
        else:
            self.registered.setdefault(tag, []).append(fut)
        return fut

    def drop_recv(self, tag: int, fut: "Future") -> None:
        """A receiver was dropped (timeout/kill) before consuming: remove
        its registration; if a message already resolved into the dead
        oneshot, hand it to the next live waiter, else put it back at the
        FRONT of the undelivered queue (it arrived earliest). The ref's
        analogue is Mailbox oneshot-drop semantics (endpoint.rs:297-363:
        a dropped oneshot's send fails and the message is buffered) — a
        dropped recv never swallows a message."""
        waiters = self.registered.get(tag)
        if waiters is not None and fut in waiters:
            waiters.remove(fut)
            if not waiters:
                del self.registered[tag]
            return
        if fut.done() and fut.exception() is None:
            payload, src = fut.result()
            while waiters:
                w = waiters.pop(0)
                if not w.done():
                    w.set_result((payload, src))
                    return
            self.undelivered.setdefault(tag, deque()).appendleft((payload, src))


class BindGuard:
    """RAII-ish port release (ref ``BindGuard``, net/mod.rs:436-494):
    explicit ``release`` or node reset frees the port; release is skipped
    when the node has been killed (its socket table was already reset)."""

    def __init__(self, netsim: NetSim, node: NodeId, addr: Addr, proto: str):
        self.netsim = netsim
        self.node = node
        self.addr = addr
        self.proto = proto
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self.netsim.network.close_socket(self.node, self.addr, self.proto)


class _EndpointSocket:
    """The Socket registered in the network table; delivers datagrams into
    the mailbox and connections into the accept queue
    (ref ``EndpointSocket::deliver``, endpoint.rs:311-351)."""

    def __init__(self) -> None:
        self.mailbox = Mailbox()
        self.accept_queue: Deque[Tuple[Addr, Tuple[PipeSender, PipeReceiver]]] = (
            deque()
        )
        self.accept_waiters: List[Future] = []

    def deliver(self, src: Addr, dst: Addr, msg: Any) -> None:
        tag, payload = msg
        self.mailbox.deliver(tag, payload, src)

    def accept_connection(
        self, src: Addr, dst: Addr, half: Tuple[PipeSender, PipeReceiver]
    ) -> None:
        while self.accept_waiters:
            fut = self.accept_waiters.pop(0)
            if not fut.done():
                fut.set_result((src, half))
                return
        self.accept_queue.append((src, half))


class Endpoint:
    """ref ``Endpoint`` (endpoint.rs:13-295)."""

    def __init__(
        self, netsim: NetSim, node: NodeId, addr: Addr, socket: _EndpointSocket
    ):
        self._netsim = netsim
        self.node = node
        self.addr = addr
        self._socket = socket
        self._guard = BindGuard(netsim, node, addr, UDP)
        self._peer: Optional[Addr] = None

    # -- construction ------------------------------------------------------

    @staticmethod
    async def bind(addr: "str | Addr") -> "Endpoint":
        """Bind on the current node; port 0 = ephemeral
        (ref endpoint.rs:29-42)."""
        netsim = simulator(NetSim)
        node = current_node().id
        ip, port = parse_addr(addr)
        if ip == "localhost":
            ip = "127.0.0.1"
        socket = _EndpointSocket()
        bound = netsim.network.bind(node, (ip, port), UDP, socket)
        return Endpoint(netsim, node, bound, socket)

    @staticmethod
    async def connect(addr: "str | Addr") -> "Endpoint":
        """Bind an ephemeral port with a default peer (endpoint.rs:44-56)."""
        netsim = simulator(NetSim)
        ep = await Endpoint.bind(("0.0.0.0", 0))
        ep._peer = netsim.resolve_host(addr)
        return ep

    def local_addr(self) -> Addr:
        return self.addr

    def peer_addr(self) -> Addr:
        if self._peer is None:
            raise OSError("endpoint is not connected")
        return self._peer

    def close(self) -> None:
        self._guard.release()

    def __enter__(self) -> "Endpoint":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- tag-matching datagram API (endpoint.rs:69-149) --------------------

    async def send_to_raw(
        self,
        dst: "str | Addr",
        tag: int,
        payload: Any,
        kind: Optional[str] = None,
    ) -> None:
        dst_addr = self._netsim.resolve_host(dst)
        await self._netsim.send_raw(
            self.node, self.addr, dst_addr, tag, payload, kind=kind
        )

    async def recv_from_raw(self, tag: int) -> Tuple[Any, Addr]:
        mailbox = self._socket.mailbox
        fut = mailbox.recv(tag)
        try:
            payload, src = await fut
            # rand_delay inside the try: a drop landing between
            # resolution and return must also requeue, not lose
            await self._netsim.rand_delay()
        except BaseException:
            # dropped mid-wait (timeout expiry / task kill closes the
            # coroutine): release the mailbox slot — or requeue an
            # already-resolved message — so nothing is swallowed by a
            # dead receiver
            mailbox.drop_recv(tag, fut)
            raise
        return payload, src

    async def send_to(self, dst: "str | Addr", tag: int, data: bytes) -> None:
        await self.send_to_raw(dst, tag, bytes(data))

    async def recv_from(self, tag: int) -> Tuple[bytes, Addr]:
        payload, src = await self.recv_from_raw(tag)
        return payload, src

    async def send(self, tag: int, data: bytes) -> None:
        await self.send_to(self.peer_addr(), tag, data)

    async def recv(self, tag: int) -> bytes:
        data, _src = await self.recv_from(tag)
        return data

    # -- connection-oriented API (endpoint.rs connect1/accept1) ------------

    async def connect1(
        self, dst: "str | Addr"
    ) -> Tuple[PipeSender, PipeReceiver]:
        return await self._netsim.connect1(self.node, self.addr, dst)

    async def accept1(self) -> Tuple[PipeSender, PipeReceiver, Addr]:
        sock = self._socket
        if sock.accept_queue:
            src, half = sock.accept_queue.popleft()
        else:
            fut: Future = Future()
            sock.accept_waiters.append(fut)
            src, half = await fut
        sender, receiver = half
        return sender, receiver, src

    # -- built-in RPC (implemented in net.rpc; ref net/rpc.rs:73-167) ------

    async def call(self, dst: "str | Addr", req: Any) -> Any:
        from .rpc import call

        return await call(self, dst, req)

    async def call_with_data(
        self, dst: "str | Addr", req: Any, data: bytes
    ) -> Tuple[Any, bytes]:
        from .rpc import call_with_data

        return await call_with_data(self, dst, req, data)

    async def call_timeout(
        self, dst: "str | Addr", req: Any, timeout_s: float
    ) -> Any:
        from .rpc import call_timeout

        return await call_timeout(self, dst, req, timeout_s)

    def add_rpc_handler(self, req_type: type, handler: Any) -> None:
        from .rpc import add_rpc_handler

        add_rpc_handler(self, req_type, handler)

    def add_rpc_handler_with_data(self, req_type: type, handler: Any) -> None:
        from .rpc import add_rpc_handler_with_data

        add_rpc_handler_with_data(self, req_type, handler)


async def connect1_ephemeral(dst: "str | Addr") -> Tuple[PipeSender, PipeReceiver]:
    """Open a reliable connection from an ephemeral port, releasing the
    port as soon as the connection is established (the pipes don't use the
    socket table) — the analogue of the reference's RAII Endpoint drop.
    Shared by the gRPC and etcd clients' call paths."""
    ep = await Endpoint.bind(("0.0.0.0", 0))
    try:
        return await ep.connect1(dst)
    finally:
        ep.close()


async def exchange1(tx: Any, rx: Any, req: Any) -> Any:
    """One request/response over a freshly opened connection pair: send,
    half-close the sender, await the single reply. The receiver half is
    ALWAYS closed — in real mode that frees the socket; in sim it marks
    the pipe closed (harmless). Returns the reply, or ``None`` if the
    peer closed without answering. The one-shot exchange discipline shared
    by the etcd / kafka / s3 client call paths (each maps transport errors
    to its own error type)."""
    try:
        await tx.send(req)
        tx.close()
        return await rx.recv()
    finally:
        rx.close()


async def lookup_host(addr: "str | Addr") -> List[Addr]:
    """Resolve a host:port through simulated DNS
    (ref ``lookup_host``, net/addr.rs:33-360)."""
    netsim = simulator(NetSim)
    return [netsim.resolve_host(addr)]


def _current_netsim() -> NetSim:
    return current_handle().simulator(NetSim)
