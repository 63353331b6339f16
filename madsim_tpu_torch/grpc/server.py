"""gRPC server: builder + router + per-connection dispatch.

Mirrors madsim-tonic ``transport::Server`` (transport/server.rs:210-335):
``Server.builder().add_service(a).add_service(b).serve(addr)`` binds a sim
Endpoint, accepts connections in a loop, routes each request by the service
name parsed from the path, spawns a task per request, and falls back to
``Unimplemented`` for unknown services/methods. All four streaming shapes
are handled; handler ``Status`` errors become ``("err", Status)`` replies;
mid-stream errors become status trailers.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional

from .. import task as mstask
from ..futures import Future
from ..net.endpoint import Endpoint as NetEndpoint
from .codec import EOS, ERR, Streaming
from .service import camel, method_table, service_name
from .status import Status


class Server:
    @staticmethod
    def builder() -> "ServerBuilder":
        return ServerBuilder()


class ServerBuilder:
    _router_cls: "type | None" = None  # real/grpc.py overrides

    def __init__(self) -> None:
        self._services: Dict[str, Any] = {}

    # accepted-and-ignored tuning knobs (transport/server.rs accepts ~10)
    def _ignore(self, *_a: Any, **_k: Any) -> "ServerBuilder":
        return self

    timeout = _ignore
    concurrency_limit_per_connection = _ignore
    initial_stream_window_size = _ignore
    initial_connection_window_size = _ignore
    max_concurrent_streams = _ignore
    tcp_keepalive = _ignore
    tcp_nodelay = _ignore
    http2_keepalive_interval = _ignore
    http2_keepalive_timeout = _ignore
    max_frame_size = _ignore
    accept_http1 = _ignore
    layer = _ignore

    def add_service(self, svc: Any) -> "Router":
        return (self._router_cls or Router)(self)._add(svc)

    def add_optional_service(self, svc: Optional[Any]) -> "Router":
        router = (self._router_cls or Router)(self)
        return router._add(svc) if svc is not None else router


class Router:
    """Routes by service name (transport/server.rs:258-272).

    ``_spawn`` and the serve/accept loop are the only executor-bound
    pieces; real/grpc.py subclasses override them to serve the SAME
    service classes over real TCP."""

    _spawn = staticmethod(mstask.spawn)

    def __init__(self, builder: ServerBuilder):
        self._services: Dict[str, Any] = dict(builder._services)
        #: set once the listener is bound; lets callers serve on port 0
        #: and discover the address (handy in real mode)
        self.bound_addr: Optional[tuple] = None

    def _add(self, svc: Any) -> "Router":
        self._services[service_name(svc)] = svc
        return self

    def add_service(self, svc: Any) -> "Router":
        return self._add(svc)

    async def serve(self, addr: "str | tuple") -> None:
        await self.serve_with_shutdown(addr, None)

    @staticmethod
    async def _bind(addr: "str | tuple") -> Any:
        """Listener factory (anything with accept1/close) — the one
        transport-bound step; real mode binds a StreamListener instead."""
        return await NetEndpoint.bind(addr)

    async def serve_with_shutdown(
        self, addr: "str | tuple", signal: Optional[Any]
    ) -> None:
        """Accept-loop until ``signal`` (an awaitable) resolves; ``None``
        serves forever (transport/server.rs:217-237)."""
        ep = await self._bind(addr)
        local = getattr(ep, "local_addr", None)
        self.bound_addr = local() if callable(local) else None
        accept_task = self._spawn(self._accept_loop(ep), name=f"grpc-serve {addr}")
        try:
            if signal is None:
                await accept_task
            else:
                await signal
        finally:
            accept_task.abort()
            ep.close()

    async def _accept_loop(self, ep: Any) -> None:
        while True:
            tx, rx, _src = await ep.accept1()
            self._spawn(self._serve_conn(tx, rx), name="grpc-conn")

    async def _serve_conn(self, tx: Any, rx: Any) -> None:
        try:
            head = await rx.recv()
        except ConnectionResetError:
            return
        if head is None:
            return
        path, server_streaming, request = head
        svc_name, _, method_path = path.strip("/").partition("/")
        svc = self._services.get(svc_name)
        handler = None
        kind = None
        if svc is not None:
            table = method_table(svc)
            for name, k in table.items():
                if method_path in (name, camel(name)):
                    handler, kind = getattr(svc, name), k
                    break
        if handler is None:
            try:
                await tx.send(("err", Status.unimplemented(f"unknown path {path}")))
            except BrokenPipeError:
                pass
            tx.close()
            return
        # task per request (transport/server.rs:275-333)
        self._spawn(
            self._dispatch(kind, handler, request, tx, rx),
            name=f"grpc-handle {path}",
        )

    @staticmethod
    async def _dispatch(kind: str, handler: Any, request: Any, tx: Any, rx: Any) -> None:
        try:
            if kind == "unary":
                result = await handler(request)
                await tx.send(("ok", _into_response(result)))
            elif kind == "client_streaming":
                result = await handler(Streaming(rx))
                await tx.send(("ok", _into_response(result)))
            elif kind == "server_streaming":
                agen = handler(request)
                await _serve_stream(tx, agen)
                return
            else:  # bidi
                agen = handler(Streaming(rx))
                await _serve_stream(tx, agen)
                return
        except Status as st:
            try:
                await tx.send(("err", st))
            except BrokenPipeError:
                pass
        except (BrokenPipeError, ConnectionResetError):
            pass  # client (or our node's route to it) went away mid-call
        finally:
            tx.close()


def _into_response(result: Any) -> Any:
    from .client import Response

    return result if isinstance(result, Response) else Response(result)


async def _serve_stream(tx: Any, agen: Any) -> None:
    """Send ok-head, then the stream body, then the EOS trailer; a Status
    raised mid-stream becomes a status trailer (server.rs:300-333)."""
    from .client import Response

    if inspect.iscoroutine(agen):
        agen = await agen  # handler returned an awaitable of an iterator
    try:
        await tx.send(("ok", Response(None)))
        if hasattr(agen, "__aiter__"):
            async for msg in agen:
                await tx.send(msg)
        else:
            for msg in agen:
                await tx.send(msg)
        await tx.send(EOS)
    except Status as st:
        try:
            await tx.send((ERR, st))
        except BrokenPipeError:
            pass
    except BrokenPipeError:
        pass
