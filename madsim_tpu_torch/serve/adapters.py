"""The three adapter shapes that put every wire tier on the core.

- :class:`PureFrameAdapter` — 4-byte length-prefixed frames in, a pure
  ``handle_frame(bytes) -> bytes|None`` out (the Kafka binary wire; any
  framed request/response codec).
- :class:`HttpAdapter` — incremental HTTP/1.1 requests in, rendered
  response bytes out (the S3 REST wire), with an optional per-request
  stall hook for gray-failure injection (fsync stall: the handler's
  response is withheld for N seconds without blocking the loop).
- :class:`ChannelAdapter` — re-creates the sim tier's pull-style
  ``(tx, rx)`` pipe surface per connection and spawns the wire's
  existing ``conn_handler(tx, rx)`` coroutine over it, so dispatchers
  written against ``PipeSender``/``PipeReceiver`` semantics (the etcd
  request-enum server, framed gRPC) ride the core unchanged.

Adapters carry no I/O of their own: the core owns sockets, framing
buffers, bounded queues, and metrics; adapters own protocol meaning.
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, Optional, Tuple

from .core import Conn, WireAdapter
from .framing import (
    HttpRequest,
    HttpRequestFramer,
    LengthPrefixFramer,
    frame as _frame,
    render_http_response,
)

__all__ = [
    "ChannelAdapter",
    "ChannelReceiver",
    "ChannelSender",
    "HttpAdapter",
    "PureFrameAdapter",
]


class PureFrameAdapter(WireAdapter):
    """Length-prefixed frames dispatched to a pure sync handler.

    ``handler(frame: bytes) -> Optional[bytes]`` — the ``handle_frame``
    shape. The response body is length-prefixed on the way out.
    ``drop_errors`` lists handler exceptions meaning protocol violation
    (hard-drop, like a real broker). ``connect_hook`` lets the wire keep
    its legacy per-wire connection counter.
    """

    def __init__(
        self,
        handler: Callable[[bytes], Optional[bytes]],
        name: str = "frame",
        drop_errors: Tuple[type, ...] = (),
        connect_hook: Optional[Callable[[Conn], None]] = None,
    ):
        self.handler = handler
        self.name = name
        self.drop_errors = drop_errors
        self._connect_hook = connect_hook

    def new_framer(self) -> LengthPrefixFramer:
        return LengthPrefixFramer()

    def on_connect(self, conn: Conn) -> None:
        if self._connect_hook is not None:
            self._connect_hook(conn)

    def on_frame(self, conn: Conn, frame: bytes) -> Optional[bytes]:
        rsp = self.handler(frame)
        return None if rsp is None else _frame(rsp)


class HttpAdapter(WireAdapter):
    """HTTP/1.1 requests dispatched to a sync handler returning a
    rendered response.

    ``handler(req: HttpRequest) -> (status, body, headers)`` — rendering
    (Content-Length, HEAD body suppression) happens here so handlers
    stay pure. ``stall_hook(req) -> float`` seconds (0 = none) lets the
    load rig inject an fsync-style stall: the response is computed at
    its deterministic position in the request order but withheld without
    blocking other connections.
    """

    def __init__(
        self,
        handler: Callable[[HttpRequest], Tuple[int, bytes, dict]],
        name: str = "http",
        drop_errors: Tuple[type, ...] = (),
        connect_hook: Optional[Callable[[Conn], None]] = None,
    ):
        self.handler = handler
        self.name = name
        self.drop_errors = drop_errors
        self._connect_hook = connect_hook
        self.stall_hook: Optional[Callable[[HttpRequest], float]] = None

    def new_framer(self) -> HttpRequestFramer:
        return HttpRequestFramer()

    def on_connect(self, conn: Conn) -> None:
        if self._connect_hook is not None:
            self._connect_hook(conn)

    def on_frame(self, conn: Conn, req: HttpRequest) -> Any:
        status, body, headers = self.handler(req)
        rendered = render_http_response(
            status, body, headers, head_only=req.method == "HEAD"
        )
        delay = self.stall_hook(req) if self.stall_hook is not None else 0.0
        if delay and delay > 0:
            async def _stalled(data=rendered, d=delay):
                await asyncio.sleep(d)
                return data

            return _stalled()
        return rendered


# ---------------------------------------------------------------------------
# pull-style channel surface over a core connection


class ChannelSender:
    """``PipeSender``/``StreamSender`` semantics over a core ``Conn``."""

    __slots__ = ("_conn", "_codec", "_closed")

    def __init__(self, conn: Conn, codec):
        self._conn = conn
        self._codec = codec
        self._closed = False

    async def send(self, msg: object) -> None:
        if self._closed or self._conn.closed:
            raise BrokenPipeError("connection closed")
        self._conn.send(_frame(self._codec.dumps(msg)))
        # bounded-queue backpressure: a streaming sender waits for a
        # slow client instead of growing the heap (or being evicted)
        await self._conn.drained()

    def close(self) -> None:
        """Clean EOF: pending frames flush, then the peer sees FIN."""
        if self._closed:
            return
        self._closed = True
        self._conn.close()

    def is_closed(self) -> bool:
        return self._closed or self._conn.closed


class ChannelReceiver:
    """``PipeReceiver``/``StreamReceiver`` semantics over a core
    ``Conn``: ``None`` on clean EOF, ``ConnectionResetError`` on abort,
    ``close()`` hard-drops."""

    _EOF = object()
    _RESET = object()

    __slots__ = ("_conn", "_q", "_done")

    def __init__(self, conn: Conn):
        self._conn = conn
        self._q: "asyncio.Queue" = asyncio.Queue()
        self._done = False

    async def recv(self) -> Optional[object]:
        if self._done:
            return None
        item = await self._q.get()
        if self._q.qsize() <= ChannelAdapter.MAX_INBOX:
            self._conn.resume_reading("handler-backlog")
        if item is ChannelReceiver._EOF:
            self._done = True
            return None
        if item is ChannelReceiver._RESET:
            self._done = True
            raise ConnectionResetError("connection reset")
        return item

    def close(self) -> None:
        self._done = True
        self._conn.abort()


class ChannelAdapter(WireAdapter):
    """Run a pull-style ``conn_handler(tx, rx)`` per connection.

    ``conn_handler`` is the wire's existing dispatcher coroutine (e.g.
    ``etcd.server.SimServer._serve_conn``); ``codec`` provides
    ``dumps``/``loads`` (``real/codec.py``) and a decode failure drops
    the connection like any protocol violation.
    """

    #: decoded-but-unclaimed inbox bound before the read side pauses
    MAX_INBOX = 32

    def __init__(
        self,
        conn_handler: Callable[..., Any],
        codec,
        name: str = "channel",
        connect_hook: Optional[Callable[[Conn], None]] = None,
    ):
        self.conn_handler = conn_handler
        self.codec = codec
        self.name = name
        self._connect_hook = connect_hook

    def new_framer(self) -> LengthPrefixFramer:
        return LengthPrefixFramer()

    def on_connect(self, conn: Conn) -> None:
        if self._connect_hook is not None:
            self._connect_hook(conn)
        tx = ChannelSender(conn, self.codec)
        rx = ChannelReceiver(conn)
        task = conn.loop.create_task(self._run(conn, tx, rx))
        conn.state = (rx, task)

    async def _run(self, conn: Conn, tx: ChannelSender,
                   rx: ChannelReceiver) -> None:
        try:
            await self.conn_handler(tx, rx)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception:  # noqa: BLE001 — a handler bug drops one conn
            conn.abort()

    def on_frame(self, conn: Conn, frame: bytes) -> None:
        rx, _task = conn.state
        try:
            obj = self.codec.loads(frame)
        except Exception:
            # protocol violation: kill the connection, like StreamReceiver
            conn.abort()
            return
        rx._q.put_nowait(obj)
        if rx._q.qsize() > ChannelAdapter.MAX_INBOX:
            conn.pause_reading("handler-backlog")

    def on_eof(self, conn: Conn) -> None:
        rx, _task = conn.state
        rx._q.put_nowait(ChannelReceiver._EOF)
        # the write half stays open: the handler may still be streaming

    def on_disconnect(self, conn: Conn, exc) -> None:
        if conn.state is None:
            return
        rx, _task = conn.state
        rx._q.put_nowait(ChannelReceiver._RESET)
