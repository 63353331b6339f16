"""Real-mode networking: tag-matching Endpoints over real UDP and TCP.

The reference's std Endpoint speaks length-delimited frames over real TCP
with a tag→mailbox dispatcher and RPC on top (madsim/src/std/net/tcp.rs:
42-327, std/net/rpc.rs). Two transports here:

- ``Endpoint`` — asyncio UDP: datagram framing for free, lowest latency,
  but a ~64 KiB payload ceiling and no delivery guarantee;
- ``TcpEndpoint`` — the reference-parity transport: 4-byte length-prefixed
  frames over persistent TCP connections. Each endpoint listens; a dialer
  opens one connection per peer, announces its own listen port in a hello
  frame (so replies ride the same connection back — the peer map of
  tcp.rs). A cached connection that errors or EOFs is evicted and the
  next send redials. Delivery is at-most-once, as in the sim tier: a
  frame written just as the peer dies is lost without an error (TCP
  buffers locally), so reliability — retries, RPC timeouts — belongs to
  the layer above, exactly as with the simulated lossy network.

Both speak the restricted binary codec (real/codec.py) — NOT pickle: a
frame from an untrusted peer can only materialize plain data or registered
``Request`` types, never run code. The mailbox matches tags exactly like
the sim side, and the built-in RPC reuses the sim's Request/hash
conventions so the same service classes work in both modes.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List, Optional, Tuple

from ..net.rpc import request_id
from . import codec
from . import time as rtime
from .runtime import spawn

# one source of truth for the wire rules, shared with the connection-
# oriented transport (real/stream.py)
from .stream import _LEN, _MAX_FRAME, encode_frame, parse_addr as _parse

Addr = Tuple[str, int]


class _Mailbox:
    def __init__(self) -> None:
        self.msgs: Dict[int, List[Tuple[Any, Addr]]] = {}
        self.waiters: Dict[int, List[asyncio.Future]] = {}

    def deliver(self, tag: int, payload: Any, src: Addr) -> None:
        waiters = self.waiters.get(tag)
        while waiters:
            fut = waiters.pop(0)
            if not fut.done():
                fut.set_result((payload, src))
                return
        self.msgs.setdefault(tag, []).append((payload, src))

    async def recv(self, tag: int) -> Tuple[Any, Addr]:
        pending = self.msgs.get(tag)
        if pending:
            return pending.pop(0)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.waiters.setdefault(tag, []).append(fut)
        return await fut


# marker for a server-side response-encoding failure: without it the
# client would wait forever on a response the server could never send
_RPC_ERR = "__madsim_rpc_error__"


class RpcError(Exception):
    """Server-side RPC failure relayed to the caller (e.g. a response type
    that is not wire-encodable — register it or return plain data)."""


class _RpcAPI:
    """Built-in RPC over any tag-matching transport (same wire convention
    as the sim side: ``(rsp_tag, req, data)`` on ``tag=RPC_ID``)."""

    async def send_to_raw(self, dst, tag, payload) -> None:  # pragma: no cover
        raise NotImplementedError

    async def recv_from_raw(self, tag):  # pragma: no cover
        raise NotImplementedError

    async def call(self, dst: "str | Addr", req: Any) -> Any:
        import random as _random

        rsp_tag = _random.getrandbits(64)
        await self.send_to_raw(dst, request_id(req), (rsp_tag, req, b""))
        payload, _src = await self.recv_from_raw(rsp_tag)
        rsp, _data = payload
        if isinstance(rsp, tuple) and len(rsp) == 2 and rsp[0] == _RPC_ERR:
            raise RpcError(rsp[1])
        return rsp

    async def call_timeout(self, dst: "str | Addr", req: Any, timeout_s: float) -> Any:
        return await rtime.timeout(timeout_s, self.call(dst, req))

    def add_rpc_handler(self, req_type: type, handler: Any) -> None:
        rid = request_id(req_type)

        async def accept_loop() -> None:
            while True:
                payload, src = await self.recv_from_raw(rid)
                rsp_tag, req, _data = payload

                async def handle_one(req=req, rsp_tag=rsp_tag, src=src) -> None:
                    rsp = await handler(req)
                    try:
                        await self.send_to_raw(src, rsp_tag, (rsp, b""))
                    except codec.CodecError as e:
                        # un-encodable response: fail the CALLER loudly
                        # instead of hanging it forever
                        await self.send_to_raw(
                            src, rsp_tag, ((_RPC_ERR, str(e)), b"")
                        )

                spawn(handle_one())

        spawn(accept_loop())


class _Proto(asyncio.DatagramProtocol):
    def __init__(self, mailbox: _Mailbox):
        self.mailbox = mailbox

    def datagram_received(self, data: bytes, addr: Addr) -> None:
        try:
            tag, payload = codec.loads(data)
        except Exception:
            return  # malformed or disallowed frame — drop, like a bad packet
        self.mailbox.deliver(tag, payload, addr)


class Endpoint(_RpcAPI):
    """Tag-matching datagram endpoint over a real UDP socket."""

    def __init__(self, transport: asyncio.DatagramTransport, mailbox: _Mailbox):
        self._transport = transport
        self._mailbox = mailbox
        self._peer: Optional[Addr] = None

    @staticmethod
    async def bind(addr: "str | Addr") -> "Endpoint":
        loop = asyncio.get_running_loop()
        mailbox = _Mailbox()
        transport, _ = await loop.create_datagram_endpoint(
            lambda: _Proto(mailbox), local_addr=_parse(addr)
        )
        return Endpoint(transport, mailbox)

    @staticmethod
    async def connect(addr: "str | Addr") -> "Endpoint":
        ep = await Endpoint.bind(("127.0.0.1", 0))
        ep._peer = _parse(addr)
        return ep

    def local_addr(self) -> Addr:
        return self._transport.get_extra_info("sockname")[:2]

    def peer_addr(self) -> Addr:
        if self._peer is None:
            raise OSError("endpoint is not connected")
        return self._peer

    def close(self) -> None:
        self._transport.close()

    # -- tag-matching datagram API ----------------------------------------

    async def send_to_raw(self, dst: "str | Addr", tag: int, payload: Any) -> None:
        self._transport.sendto(codec.dumps((tag, payload)), _parse(dst))

    async def recv_from_raw(self, tag: int) -> Tuple[Any, Addr]:
        return await self._mailbox.recv(tag)

    async def send_to(self, dst: "str | Addr", tag: int, data: bytes) -> None:
        await self.send_to_raw(dst, tag, bytes(data))

    async def recv_from(self, tag: int) -> Tuple[bytes, Addr]:
        return await self.recv_from_raw(tag)

    async def send(self, tag: int, data: bytes) -> None:
        await self.send_to(self.peer_addr(), tag, data)

    async def recv(self, tag: int) -> bytes:
        data, _ = await self.recv_from(tag)
        return data


class _TcpConn:
    """One live framed connection to a peer (either direction)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer

    async def write_frame(self, body: bytes) -> None:
        self.writer.write(encode_frame(body))
        await self.writer.drain()

    async def read_frame(self) -> bytes:
        head = await self.reader.readexactly(_LEN.size)
        (n,) = _LEN.unpack(head)
        if n > _MAX_FRAME:
            raise ConnectionError(f"frame of {n} bytes exceeds sanity bound")
        return await self.reader.readexactly(n)

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass


class TcpEndpoint(_RpcAPI):
    """Tag-matching endpoint over persistent length-delimited TCP
    connections — the reference std transport's shape (std/net/tcp.rs:
    42-327: listener + peer map + (tag, payload) frames)."""

    def __init__(self) -> None:
        self._mailbox = _Mailbox()
        self._conns: Dict[Addr, _TcpConn] = {}
        self._dial_locks: Dict[Addr, asyncio.Lock] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._local: Addr = ("0.0.0.0", 0)

    @staticmethod
    async def bind(addr: "str | Addr") -> "TcpEndpoint":
        ep = TcpEndpoint()
        host, port = _parse(addr)
        ep._server = await asyncio.start_server(ep._on_accept, host, port)
        ep._local = ep._server.sockets[0].getsockname()[:2]
        return ep

    def local_addr(self) -> Addr:
        return self._local

    def close(self) -> None:
        if self._server is not None:
            self._server.close()
        for conn in list(self._conns.values()):
            conn.close()
        self._conns.clear()

    # -- connection management ---------------------------------------------

    async def _on_accept(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        conn = _TcpConn(reader, writer)
        try:
            # The hello frame announces the dialer's LISTEN PORT (its
            # socket peername is an undialable ephemeral port). Only the
            # port is trusted: the host half of the key is the IP the TCP
            # connection actually comes from, so a peer can neither claim
            # another node's address (hello poisoning) nor collide with
            # other nodes by announcing a wildcard bind like 0.0.0.0.
            kind, claimed = codec.loads(await conn.read_frame())
            if kind != "hello":
                raise ConnectionError("expected hello frame")
            observed_ip = writer.get_extra_info("peername")[0]
            peer = (observed_ip, int(claimed[1]))
        except Exception:
            conn.close()
            return
        self._conns.setdefault(peer, conn)
        await self._read_loop(peer, conn)

    async def _read_loop(self, peer: Addr, conn: _TcpConn) -> None:
        try:
            while True:
                tag, payload = codec.loads(await conn.read_frame())
                self._mailbox.deliver(tag, payload, peer)
        except Exception:
            pass  # EOF, reset, or malformed frame: connection is done
        finally:
            if self._conns.get(peer) is conn:
                del self._conns[peer]
            conn.close()

    async def _connection(self, dst: Addr) -> _TcpConn:
        conn = self._conns.get(dst)
        if conn is not None:
            return conn
        lock = self._dial_locks.setdefault(dst, asyncio.Lock())
        async with lock:
            conn = self._conns.get(dst)  # raced dialer won
            if conn is not None:
                return conn
            reader, writer = await asyncio.open_connection(dst[0], dst[1])
            conn = _TcpConn(reader, writer)
            await conn.write_frame(codec.dumps(("hello", self._local)))
            self._conns[dst] = conn
            spawn(self._read_loop(dst, conn))
            return conn

    # -- tag-matching API ----------------------------------------------------

    async def send_to_raw(self, dst: "str | Addr", tag: int, payload: Any) -> None:
        dst = _parse(dst)
        body = codec.dumps((tag, payload))
        for attempt in (0, 1):
            conn = await self._connection(dst)
            try:
                await conn.write_frame(body)
                return
            except Exception:
                # cached connection died: evict and redial once
                if self._conns.get(dst) is conn:
                    del self._conns[dst]
                conn.close()
                if attempt == 1:
                    raise

    async def recv_from_raw(self, tag: int) -> Tuple[Any, Addr]:
        return await self._mailbox.recv(tag)

    async def send_to(self, dst: "str | Addr", tag: int, data: bytes) -> None:
        await self.send_to_raw(dst, tag, bytes(data))

    async def recv_from(self, tag: int) -> Tuple[bytes, Addr]:
        return await self.recv_from_raw(tag)
