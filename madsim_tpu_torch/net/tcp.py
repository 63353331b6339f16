"""Simulated TCP (ref madsim/src/sim/net/tcp/{mod,listener,stream}.rs).

``TcpListener::bind/accept`` over an Endpoint accept queue
(listener.rs:35-64); ``TcpStream`` buffers writes locally and ``flush``
sends one message; reads pull from the reliable channel; EOF = channel
closed (stream.rs:133-186).  Streams survive link clogs via the channel's
backoff-retry (netsim.PipeReceiver).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from .endpoint import Endpoint
from .netsim import PipeReceiver, PipeSender
from .network import Addr


class TcpStream:
    def __init__(
        self,
        sender: PipeSender,
        receiver: PipeReceiver,
        local: Addr,
        peer: Addr,
        ep: Optional[Endpoint] = None,
    ):
        self._sender = sender
        self._receiver = receiver
        self._local = local
        self._peer = peer
        self._ep = ep  # keeps the client's ephemeral port alive
        self._wbuf = bytearray()
        self._rbuf = bytearray()
        self._eof = False

    @staticmethod
    async def connect(addr: "str | Addr") -> "TcpStream":
        """ref stream.rs:37-60."""
        ep = await Endpoint.connect(addr)
        sender, receiver = await ep.connect1(addr)
        return TcpStream(sender, receiver, ep.local_addr(), ep.peer_addr(), ep)

    def local_addr(self) -> Addr:
        return self._local

    def peer_addr(self) -> Addr:
        return self._peer

    # -- write side (buffer until flush, stream.rs:133-162) ----------------

    def write(self, data: bytes) -> int:
        self._wbuf += data
        return len(data)

    async def write_all(self, data: bytes) -> None:
        self.write(data)

    async def flush(self) -> None:
        if self._wbuf:
            buf, self._wbuf = bytes(self._wbuf), bytearray()
            await self._sender.send(buf)

    async def write_all_flush(self, data: bytes) -> None:
        self.write(data)
        await self.flush()

    # -- read side (stream.rs:164-186) -------------------------------------

    async def read(self, n: int) -> bytes:
        if not self._rbuf and not self._eof:
            msg = await self._receiver.recv()
            if msg is None:
                self._eof = True
            else:
                self._rbuf += msg
        out = bytes(self._rbuf[:n])
        del self._rbuf[:n]
        return out

    async def read_exact(self, n: int) -> bytes:
        while len(self._rbuf) < n and not self._eof:
            msg = await self._receiver.recv()
            if msg is None:
                self._eof = True
                break
            self._rbuf += msg
        if len(self._rbuf) < n:
            raise EOFError(
                f"connection closed with {len(self._rbuf)}/{n} bytes buffered"
            )
        out = bytes(self._rbuf[:n])
        del self._rbuf[:n]
        return out

    def shutdown(self) -> None:
        """Half-close the write side (EOF at the peer)."""
        self._sender.close()

    def close(self) -> None:
        self._sender.close()
        self._receiver.close()
        if self._ep is not None:
            self._ep.close()


class TcpListener:
    """ref listener.rs:35-64."""

    def __init__(self, ep: Endpoint):
        self._ep = ep

    @staticmethod
    async def bind(addr: "str | Addr") -> "TcpListener":
        return TcpListener(await Endpoint.bind(addr))

    def local_addr(self) -> Addr:
        return self._ep.local_addr()

    async def accept(self) -> Tuple[TcpStream, Addr]:
        sender, receiver, peer = await self._ep.accept1()
        return TcpStream(sender, receiver, self._ep.local_addr(), peer), peer

    def close(self) -> None:
        self._ep.close()

    def __enter__(self) -> "TcpListener":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
