"""The async wire-serving core: one event loop multiplexing thousands
of connections for every real-TCP wire tier.

Before this package each wire owned its own accept loop and spawned one
task (or stream-callback pair) per connection with unbounded write
buffering — fine at demo scale, hopeless at thousands of clients and
impossible to give uniform backpressure or lifecycle metrics. The core
inverts that: **one** ``asyncio.Protocol``-based server owns

- framing/reassembly (pluggable per-wire framer, ``serve/framing.py``),
- per-connection state and lifecycle (``Conn``),
- write-side backpressure: transport-paused output spills into a
  **bounded** per-connection queue; a slow client that exceeds the bound
  is evicted (``serve_slow_client_drops_total``) instead of growing the
  heap,
- read-side backpressure: connections whose output backlog (or whose
  adapter-side inbox) is over the threshold stop being read
  (``transport.pause_reading``) until they drain,
- connection/byte/frame metrics through ``obs.Telemetry`` — strictly
  out-of-band, like every telemetry plane,
- clean shutdown: stop accepting, let in-flight handlers finish, flush
  write queues, then close.

Wires plug in through a :class:`WireAdapter`: ``on_frame(conn, frame)``
returns response bytes (the pure ``handle_frame`` shape — Kafka, S3) or
a coroutine (dispatched in order per connection — the framed etcd/gRPC
tiers), and may push out-of-order/streamed responses at any time via
``conn.send``. ``serve/adapters.py`` holds the three adapter shapes;
the per-wire modules keep only protocol logic.

Optionally the listener shards across N event loops (``shards=``): each
shard binds its own ``SO_REUSEPORT`` socket on a daemon-thread loop and
the kernel spreads accepts across them. Because the served state
machines (Broker/S3Service/EtcdService) are single-writer, sharded
dispatch serializes ``on_frame`` under one lock — shards parallelize
framing and socket I/O, not state-machine work — and is limited to
adapters whose handlers are synchronous.
"""

from __future__ import annotations

import asyncio
import socket
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from .framing import FramingError

__all__ = [
    "AsyncWireServer",
    "Conn",
    "DropConnection",
    "WireAdapter",
]


class DropConnection(Exception):
    """Raised by an adapter to hard-drop the connection (protocol
    violation semantics: the peer sees a reset, not a clean EOF)."""


class WireAdapter:
    """What a wire plugs into the core. Subclasses override:

    - ``name`` — the ``wire=`` metric label;
    - ``new_framer()`` — per-connection framer (``feed(bytes)->list``);
    - ``on_frame(conn, frame)`` — one protocol unit. Return response
      ``bytes`` (written through the bounded queue), ``None`` (no
      response), or a coroutine (awaited in order per connection; its
      return value, if bytes, is written). Raise :class:`DropConnection`
      (or an exception listed in ``drop_errors``) to hard-drop.
    - ``on_connect(conn)`` / ``on_eof(conn)`` / ``on_disconnect(conn,
      exc)`` — lifecycle. Default EOF behavior closes the connection
      after pending responses flush (the task-per-conn servers' shape).
    """

    name = "wire"
    #: exception types from ``on_frame`` that mean "protocol violation:
    #: drop the connection" rather than "bug: log and drop anyway"
    drop_errors: Tuple[type, ...] = ()

    def new_framer(self):
        raise NotImplementedError

    def on_connect(self, conn: "Conn") -> None:
        pass

    def on_frame(self, conn: "Conn", frame) -> Any:
        raise NotImplementedError

    def on_eof(self, conn: "Conn") -> None:
        conn.close()

    def on_disconnect(self, conn: "Conn", exc: Optional[Exception]) -> None:
        pass


class Conn:
    """One live connection: bounded write queue + pause bookkeeping.

    ``send`` never blocks: while the transport is writable it writes
    through; once the transport pauses us, output queues up to
    ``max_queue_bytes`` and an overflowing (slow) client is evicted.
    Adapters needing sender-side backpressure await :meth:`drained`.
    """

    __slots__ = (
        "server", "transport", "wire", "id", "peer", "state",
        "_writable", "_q", "_q_bytes", "_closing", "closed",
        "_pauses", "_drain_waiters", "inflight", "framer", "loop",
    )

    def __init__(self, server: "AsyncWireServer", transport, conn_id: int,
                 loop) -> None:
        self.server = server
        self.transport = transport
        self.wire = server.adapter.name
        self.id = conn_id
        self.peer = (transport.get_extra_info("peername") or ("?", 0))[:2]
        self.state: Any = None  # adapter-owned slot
        self.loop = loop
        self._writable = True
        self._q: List[bytes] = []
        self._q_bytes = 0
        self._closing = False
        self.closed = False
        self._pauses: set = set()
        self._drain_waiters: List[asyncio.Future] = []
        self.inflight = 0  # async handlers pending on this conn
        self.framer = server.adapter.new_framer()

    # -- write side ---------------------------------------------------------

    def send(self, data: bytes) -> None:
        """Queue one response; raises ``BrokenPipeError`` if the
        connection is already gone (matches the pipe-sender contract)."""
        if self.closed or self._closing:
            raise BrokenPipeError("connection closed")
        srv = self.server
        if srv.telemetry is not None:
            srv.telemetry.count(
                "serve_bytes_out_total", len(data),
                help="bytes written by the serving core", wire=self.wire,
            )
        if self._writable and not self._q:
            self.transport.write(data)
            return
        self._q.append(data)
        self._q_bytes += len(data)
        if self._q_bytes > srv.max_queue_bytes:
            if srv.telemetry is not None:
                srv.telemetry.count(
                    "serve_slow_client_drops_total",
                    help="connections evicted for unread output backlog",
                    wire=self.wire,
                )
            self.abort()
            return
        if self._q_bytes > srv.read_pause_bytes:
            self.pause_reading("write-backlog")

    def _flush(self) -> None:
        """Drain the queue into a resumed transport."""
        while self._q and self._writable:
            self.transport.write(self._q.pop(0))
        if not self._q:
            if self._q_bytes:
                self._q_bytes = 0
            self.resume_reading("write-backlog")
            for f in self._drain_waiters:
                if not f.done():
                    f.set_result(None)
            self._drain_waiters.clear()
            if self._closing and not self.closed:
                self.transport.close()
        else:
            self._q_bytes = sum(len(b) for b in self._q)

    async def drained(self) -> None:
        """Resolve once the bounded queue is empty (sender-side
        backpressure for streaming adapters)."""
        if not self._q or self.closed:
            return
        f = self.loop.create_future()
        self._drain_waiters.append(f)
        await f

    # -- read-side pause bookkeeping ---------------------------------------

    def pause_reading(self, reason: str) -> None:
        if self.closed:
            return
        first = not self._pauses
        self._pauses.add(reason)
        if first:
            try:
                self.transport.pause_reading()
            except RuntimeError:  # pragma: no cover - transport closing
                return
            if self.server.telemetry is not None:
                self.server.telemetry.count(
                    "serve_backpressure_pauses_total",
                    help="read pauses applied by the serving core",
                    wire=self.wire,
                )

    def resume_reading(self, reason: str) -> None:
        if reason not in self._pauses:
            return
        self._pauses.discard(reason)
        if not self._pauses and not self.closed:
            try:
                self.transport.resume_reading()
            except RuntimeError:  # pragma: no cover - transport closing
                pass

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Flush queued output, then close (clean EOF to the peer)."""
        if self.closed or self._closing:
            return
        self._closing = True
        if not self._q:
            self.transport.close()

    def abort(self) -> None:
        """Hard-drop: the peer sees a reset; queued output is gone."""
        if self.closed:
            return
        self._closing = True
        self._q.clear()
        self._q_bytes = 0
        try:
            self.transport.abort()
        except Exception:  # pragma: no cover - transport already detached
            pass


class _WireProtocol(asyncio.Protocol):
    """The one protocol class every core-served connection runs."""

    def __init__(self, server: "AsyncWireServer", loop) -> None:
        self.server = server
        self.loop = loop
        self.conn: Optional[Conn] = None
        self._tasks: List = []  # pending coroutines (ordered)
        self._drainer: Optional[asyncio.Task] = None

    # -- transport callbacks ------------------------------------------------

    def connection_made(self, transport) -> None:
        srv = self.server
        self.conn = conn = Conn(srv, transport, srv._next_conn_id(), self.loop)
        srv._register(conn)
        if srv.telemetry is not None:
            srv.telemetry.count(
                "serve_connections_total",
                help="connections accepted by the serving core",
                wire=conn.wire,
            )
            srv.telemetry.gauge(
                "serve_connections_open", srv.open_conns(),
                help="currently open connections", wire=conn.wire,
            )
        try:
            srv.adapter.on_connect(conn)
        except Exception:
            conn.abort()

    def data_received(self, data: bytes) -> None:
        conn = self.conn
        srv = self.server
        if conn is None or conn.closed:
            return
        if srv.telemetry is not None:
            srv.telemetry.count(
                "serve_bytes_in_total", len(data),
                help="bytes read by the serving core", wire=conn.wire,
            )
        try:
            frames = conn.framer.feed(data)
        except FramingError:
            conn.abort()
            return
        for f in frames:
            if conn.closed:
                return
            self._dispatch(f)

    def _dispatch(self, frame) -> None:
        conn = self.conn
        srv = self.server
        if srv.telemetry is not None:
            srv.telemetry.count(
                "serve_frames_total",
                help="protocol units dispatched by the serving core",
                wire=conn.wire,
            )
        try:
            if srv._dispatch_lock is not None:
                with srv._dispatch_lock:
                    result = srv.adapter.on_frame(conn, frame)
            else:
                result = srv.adapter.on_frame(conn, frame)
        except DropConnection:
            conn.abort()
            return
        except srv.adapter.drop_errors:
            conn.abort()
            return
        if result is None:
            return
        if isinstance(result, (bytes, bytearray, memoryview)):
            try:
                conn.send(bytes(result))
            except BrokenPipeError:
                pass
            return
        # a coroutine: run in arrival order on this connection
        self._tasks.append(result)
        conn.inflight += 1
        srv._inflight_inc()
        if len(self._tasks) > srv.max_inflight_frames:
            conn.pause_reading("handler-backlog")
        if self._drainer is None or self._drainer.done():
            self._drainer = self.loop.create_task(self._drain_tasks())

    async def _drain_tasks(self) -> None:
        conn = self.conn
        srv = self.server
        while self._tasks:
            coro = self._tasks.pop(0)
            try:
                result = await coro
                if isinstance(result, (bytes, bytearray, memoryview)):
                    conn.send(bytes(result))
            except DropConnection:
                conn.abort()
            except srv.adapter.drop_errors:
                conn.abort()
            except (BrokenPipeError, ConnectionResetError):
                pass
            finally:
                conn.inflight -= 1
                srv._inflight_dec()
            if len(self._tasks) <= srv.max_inflight_frames:
                conn.resume_reading("handler-backlog")

    def eof_received(self) -> Optional[bool]:
        if self.conn is not None and not self.conn.closed:
            try:
                self.server.adapter.on_eof(self.conn)
            except Exception:
                self.conn.abort()
        return True  # keep the write half open until we flush

    def connection_lost(self, exc: Optional[Exception]) -> None:
        conn = self.conn
        if conn is None:
            return
        conn.closed = True
        srv = self.server
        srv._unregister(conn)
        for f in conn._drain_waiters:
            if not f.done():
                f.set_result(None)
        conn._drain_waiters.clear()
        for coro in self._tasks:  # never awaited: close, do not leak
            coro.close()
            conn.inflight -= 1
            srv._inflight_dec()
        self._tasks.clear()
        if srv.telemetry is not None:
            srv.telemetry.gauge(
                "serve_connections_open", srv.open_conns(),
                help="currently open connections", wire=conn.wire,
            )
        try:
            srv.adapter.on_disconnect(conn, exc)
        except Exception:  # noqa: BLE001 — teardown must not raise
            pass

    def pause_writing(self) -> None:
        if self.conn is not None:
            self.conn._writable = False

    def resume_writing(self) -> None:
        if self.conn is not None:
            self.conn._writable = True
            self.conn._flush()


class _Shard:
    """One extra listener loop on a daemon thread (SO_REUSEPORT)."""

    def __init__(self, server: "AsyncWireServer", sock: socket.socket):
        self.server = server
        self.sock = sock
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(
            target=self._run, name=f"serve-shard-{server.adapter.name}",
            daemon=True,
        )
        self._srv: Optional[asyncio.AbstractServer] = None

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)

        async def _bind():
            self._srv = await self.loop.create_server(
                lambda: _WireProtocol(self.server, self.loop), sock=self.sock
            )

        self.loop.run_until_complete(_bind())
        self.loop.run_forever()
        # drain callbacks queued by stop(), then close
        self.loop.run_until_complete(asyncio.sleep(0))
        self.loop.close()

    def start(self) -> None:
        self.thread.start()

    def stop(self) -> None:
        def _close():
            if self._srv is not None:
                self._srv.close()
            self.loop.stop()

        try:
            self.loop.call_soon_threadsafe(_close)
        except RuntimeError:  # pragma: no cover - loop already closed
            pass
        self.thread.join(timeout=5)


def _reuseport_socket(host: str, port: int) -> socket.socket:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind((host, port))
    s.listen(1024)
    s.setblocking(False)
    return s


class AsyncWireServer:
    """The shared serving core: one adapter, one (optionally sharded)
    listener, uniform backpressure/lifecycle/metrics."""

    def __init__(
        self,
        adapter: WireAdapter,
        *,
        telemetry=None,
        shards: int = 1,
        max_queue_bytes: int = 8 * 1024 * 1024,
        read_pause_bytes: int = 1 * 1024 * 1024,
        max_inflight_frames: int = 64,
    ):
        if shards > 1 and getattr(adapter, "async_handlers", False):
            raise ValueError(
                "loop shards require synchronous adapter handlers (the "
                "dispatch lock cannot serialize coroutines across loops)"
            )
        self.adapter = adapter
        self.telemetry = telemetry
        self.shards = max(1, int(shards))
        self.max_queue_bytes = max_queue_bytes
        self.read_pause_bytes = read_pause_bytes
        self.max_inflight_frames = max_inflight_frames
        self.bound_addr: Optional[Tuple[str, int]] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._shards: List[_Shard] = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stopped: Optional[asyncio.Event] = None
        self._conns: Dict[int, Conn] = {}
        self._conn_lock = threading.Lock()
        self._conn_seq = 0
        self._inflight = 0
        self._dispatch_lock: Optional[threading.Lock] = None

    # -- registry (thread-safe: shards touch it too) ------------------------

    def _next_conn_id(self) -> int:
        with self._conn_lock:
            self._conn_seq += 1
            return self._conn_seq

    def _register(self, conn: Conn) -> None:
        with self._conn_lock:
            self._conns[conn.id] = conn

    def _unregister(self, conn: Conn) -> None:
        with self._conn_lock:
            self._conns.pop(conn.id, None)

    def _inflight_inc(self) -> None:
        with self._conn_lock:
            self._inflight += 1

    def _inflight_dec(self) -> None:
        with self._conn_lock:
            self._inflight -= 1

    def open_conns(self) -> int:
        with self._conn_lock:
            return len(self._conns)

    def connections(self) -> List[Conn]:
        with self._conn_lock:
            return list(self._conns.values())

    # -- lifecycle ----------------------------------------------------------

    async def start(self, addr: "str | tuple") -> Tuple[str, int]:
        from ..real.stream import parse_addr

        host, port = parse_addr(addr)
        self._loop = asyncio.get_running_loop()
        self._stopped = asyncio.Event()
        if self.shards > 1:
            self._dispatch_lock = threading.Lock()
            sock0 = _reuseport_socket(host, port)
            self.bound_addr = sock0.getsockname()[:2]
            self._server = await self._loop.create_server(
                lambda: _WireProtocol(self, self._loop), sock=sock0
            )
            for _ in range(self.shards - 1):
                shard = _Shard(
                    self, _reuseport_socket(*self.bound_addr)
                )
                self._shards.append(shard)
                shard.start()
        else:
            self._server = await self._loop.create_server(
                lambda: _WireProtocol(self, self._loop), host, port
            )
            self.bound_addr = self._server.sockets[0].getsockname()[:2]
        return self.bound_addr

    async def serve(self, addr: "str | tuple") -> None:
        """Bind and serve until :meth:`close` — the drop-in shape the
        per-wire servers expose."""
        await self.start(addr)
        try:
            await self._stopped.wait()
        finally:
            self._teardown()

    def close(self) -> None:
        """Stop accepting and wake :meth:`serve`; open connections are
        dropped by the serve task's teardown (call :meth:`aclose` for a
        draining shutdown instead)."""
        if self._server is not None:
            self._server.close()
        for shard in self._shards:
            shard.stop()
        self._shards = []
        if self._stopped is not None and self._loop is not None:
            if self._loop.is_running():
                self._loop.call_soon_threadsafe(self._stopped.set)
            else:  # pragma: no cover - loop already torn down
                self._stopped.set()

    def _teardown(self) -> None:
        for conn in self.connections():
            conn.abort()

    async def aclose(self, drain_timeout: float = 5.0) -> None:
        """Graceful shutdown: stop accepting, wait for in-flight frame
        handlers, flush write queues, then close every connection."""
        if self._server is not None:
            self._server.close()
        for shard in self._shards:
            shard.stop()
        self._shards = []
        deadline = self._loop.time() + drain_timeout
        while self._loop.time() < deadline:
            with self._conn_lock:
                busy = self._inflight > 0 or any(
                    c._q for c in self._conns.values()
                )
            if not busy:
                break
            await asyncio.sleep(0.01)
        for conn in self.connections():
            conn.close()
        if self._stopped is not None:
            self._stopped.set()

    # -- gray-failure injection --------------------------------------------

    def inject_read_stall(
        self,
        duration: float,
        match: Optional[Callable[[Conn], bool]] = None,
    ) -> int:
        """Asymmetric-partition chaos: stop READING the matched
        connections for ``duration`` seconds while their write half
        stays live (the server can still talk to them — inbound is
        blackholed, the gray-failure shape). Returns how many
        connections were stalled."""
        stalled = [
            c for c in self.connections()
            if not c.closed and (match is None or match(c))
        ]
        for c in stalled:
            c.pause_reading("chaos")
        if self.telemetry is not None and stalled:
            self.telemetry.count(
                "serve_chaos_stalls_total", len(stalled),
                help="connections read-stalled by fault injection",
                wire=self.adapter.name,
            )

        def _heal() -> None:
            for c in stalled:
                c.resume_reading("chaos")

        self._loop.call_later(duration, _heal)
        return len(stalled)
