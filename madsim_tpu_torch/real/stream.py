"""Real-mode framed streams: the ``connect1``/``accept1`` shape over TCP.

The sim tier's connection-oriented protocols (gRPC, etcd) ride on
``(tx, rx)`` pipe halves from ``net/netsim.py`` (``PipeSender`` /
``PipeReceiver``).  This module provides the same surface over a real TCP
connection so those protocol layers run unmodified outside the simulator —
the analogue of the reference's std transports backing its shim crates
(madsim-tonic/src/lib.rs:1-8 compiles to real tonic without ``--cfg
madsim``; here the same service classes bind to real sockets).

Semantics match the sim pipes:

- ``tx.send(obj)``     — one codec frame; ``BrokenPipeError`` if the
                         connection is gone or the peer receiver closed it;
- ``tx.close()``       — clean EOF (TCP half-close): the peer's ``recv``
                         returns ``None`` after the in-flight frames;
- ``rx.recv()``        — next object; ``None`` on clean EOF;
                         ``ConnectionResetError`` on abort/reset;
- ``rx.close()``       — hard-drop the connection (the peer's next send
                         observes ``BrokenPipeError``), mirroring
                         ``PipeReceiver.close``.

Frames are 4-byte big-endian length + restricted-codec body (real/codec.py)
— never pickle, so a hostile peer cannot execute code.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Optional, Tuple

from . import codec

Addr = Tuple[str, int]

# the single source of truth for the wire rules — real/net.py imports these
_LEN = struct.Struct(">I")
_MAX_FRAME = 64 * 1024 * 1024  # sanity bound, not a protocol limit


def encode_frame(body: bytes) -> bytes:
    """Length-prefix one frame; oversize fails at the SENDER (the receiver
    would kill the connection)."""
    if len(body) > _MAX_FRAME:
        raise ValueError(
            f"frame of {len(body)} bytes exceeds the {_MAX_FRAME}-byte bound"
        )
    return _LEN.pack(len(body)) + body


async def read_frame_raw(reader: asyncio.StreamReader) -> Optional[bytes]:
    """Read one raw length-prefixed frame body (no codec): ``None`` on
    clean EOF at a frame boundary, ``ConnectionResetError`` mid-frame.
    The Kafka binary wire (kafka/wire.py) uses exactly this framing, so
    its real tier reads genuine protocol bytes through the same rules."""
    try:
        head = await reader.readexactly(_LEN.size)
    except asyncio.IncompleteReadError as e:
        if e.partial:
            raise ConnectionResetError("truncated frame") from None
        return None
    (n,) = _LEN.unpack(head)
    if n > _MAX_FRAME:
        raise ConnectionResetError(f"frame of {n} bytes exceeds sanity bound")
    try:
        return await reader.readexactly(n)
    except asyncio.IncompleteReadError:
        raise ConnectionResetError("truncated frame") from None


async def write_frame_raw(writer: asyncio.StreamWriter, body: bytes) -> None:
    """Write one raw length-prefixed frame body (no codec) and drain."""
    writer.write(encode_frame(body))
    await writer.drain()


def parse_addr(addr: "str | Addr") -> Addr:
    if isinstance(addr, tuple):
        return (addr[0], int(addr[1]))
    host, _, port = addr.rpartition(":")
    return (host or "127.0.0.1", int(port))


class _Conn:
    """Shared state of one TCP connection carrying a (tx, rx) pair."""

    __slots__ = ("reader", "writer", "tx_closed", "rx_done")

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.tx_closed = False  # our write half is done (EOF sent)
        self.rx_done = False  # read half hit EOF or was closed

    def maybe_close(self) -> None:
        """Fully close the socket once both directions are finished."""
        if self.tx_closed and self.rx_done:
            try:
                self.writer.close()
            except Exception:
                pass

    def abort(self) -> None:
        """Hard-drop: the peer sees a reset, not a clean EOF."""
        self.tx_closed = True
        self.rx_done = True
        try:
            transport = self.writer.transport
            if transport is not None:
                transport.abort()
            else:  # pragma: no cover - transport already detached
                self.writer.close()
        except Exception:
            pass


class StreamSender:
    """The ``PipeSender`` analogue over a real connection half."""

    def __init__(self, conn: _Conn):
        self._conn = conn

    async def send(self, msg: object) -> None:
        conn = self._conn
        if conn.tx_closed or conn.writer.is_closing():
            raise BrokenPipeError("connection closed")
        try:
            conn.writer.write(encode_frame(codec.dumps(msg)))
            await conn.writer.drain()
        except (ConnectionError, OSError) as e:
            raise BrokenPipeError(str(e) or "connection lost") from None

    def close(self) -> None:
        conn = self._conn
        if conn.tx_closed:
            return
        conn.tx_closed = True
        try:
            if conn.writer.can_write_eof() and not conn.writer.is_closing():
                conn.writer.write_eof()
            else:
                conn.writer.close()
        except (OSError, RuntimeError):
            pass
        conn.maybe_close()

    def is_closed(self) -> bool:
        return self._conn.tx_closed or self._conn.writer.is_closing()


class StreamReceiver:
    """The ``PipeReceiver`` analogue over a real connection half."""

    def __init__(self, conn: _Conn):
        self._conn = conn

    async def recv(self) -> Optional[object]:
        conn = self._conn
        if conn.rx_done:
            return None
        try:
            head = await conn.reader.readexactly(_LEN.size)
        except asyncio.IncompleteReadError as e:
            conn.rx_done = True
            if e.partial:  # connection died mid-frame
                conn.abort()
                raise ConnectionResetError("truncated frame") from None
            conn.maybe_close()
            return None  # clean EOF — the peer's tx.close()
        except (ConnectionError, OSError) as e:
            conn.rx_done = True
            raise ConnectionResetError(str(e) or "connection reset") from None
        (n,) = _LEN.unpack(head)
        if n > _MAX_FRAME:
            conn.abort()
            raise ConnectionResetError(f"frame of {n} bytes exceeds sanity bound")
        try:
            body = await conn.reader.readexactly(n)
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
            conn.rx_done = True
            conn.abort()
            raise ConnectionResetError(str(e) or "connection reset") from None
        try:
            return codec.loads(body)
        except codec.CodecError as e:
            # a frame we refuse to decode kills the connection, like a
            # protocol violation on a real wire
            conn.abort()
            raise ConnectionResetError(f"bad frame: {e}") from None

    def close(self) -> None:
        """Drop the connection hard (the ``PipeReceiver.close`` analogue:
        the peer's next send fails instead of silently buffering)."""
        conn = self._conn
        if conn.rx_done and conn.tx_closed:
            return
        conn.abort()


def _wrap(reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
    conn = _Conn(reader, writer)
    return StreamSender(conn), StreamReceiver(conn)


async def connect(addr: "str | Addr") -> Tuple[StreamSender, StreamReceiver]:
    """Open one framed connection — the ``connect1_ephemeral`` analogue."""
    host, port = parse_addr(addr)
    reader, writer = await asyncio.open_connection(host, port)
    return _wrap(reader, writer)


class StreamListener:
    """Accept-side of the framed transport — the ``accept1`` analogue.

    Closed-listener semantics: after :meth:`close`, ``accept1`` raises
    ``ConnectionAbortedError`` (it must not block forever on a listener
    that will never accept again), queued-but-unclaimed connections are
    hard-dropped so their clients see a reset instead of hanging, and a
    connection that races the close through the kernel backlog is
    aborted on arrival.
    """

    #: queue sentinel: wakes accept1 blocked at close time
    _CLOSED = (None, None, ("closed", 0))

    def __init__(self) -> None:
        self._server: Optional[asyncio.AbstractServer] = None
        self._local: Addr = ("0.0.0.0", 0)
        self._closed = False
        self._pending: "asyncio.Queue[Tuple[StreamSender, StreamReceiver, Addr]]" = (
            asyncio.Queue()
        )

    @staticmethod
    async def bind(addr: "str | Addr") -> "StreamListener":
        self = StreamListener()
        host, port = parse_addr(addr)

        async def on_accept(reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
            # peername is None for a socket that disconnected before the
            # callback ran; don't let a TypeError drop the connection
            peer = (writer.get_extra_info("peername") or ("?", 0))[:2]
            tx, rx = _wrap(reader, writer)
            if self._closed:
                # raced the close through the kernel backlog: nobody
                # will ever claim this connection — reset it now
                rx.close()
                return
            await self._pending.put((tx, rx, peer))

        self._server = await asyncio.start_server(on_accept, host, port)
        self._local = self._server.sockets[0].getsockname()[:2]
        return self

    def local_addr(self) -> Addr:
        return self._local

    async def accept1(self) -> Tuple[StreamSender, StreamReceiver, Addr]:
        if self._closed:
            raise ConnectionAbortedError("listener closed")
        item = await self._pending.get()
        if item[0] is None:  # the close sentinel
            self._pending.put_nowait(StreamListener._CLOSED)  # for siblings
            raise ConnectionAbortedError("listener closed")
        return item

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._server is not None:
            self._server.close()
        # accepted-but-unclaimed connections would otherwise hang their
        # clients forever (no EOF, no reset) — drop them hard
        while not self._pending.empty():
            try:
                item = self._pending.get_nowait()
            except asyncio.QueueEmpty:  # pragma: no cover - raced drain
                break
            if item[0] is not None:
                item[1].close()
        self._pending.put_nowait(StreamListener._CLOSED)
