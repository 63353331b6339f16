"""Real-mode gRPC twin: the same service classes over real TCP.

The reference's madsim-tonic compiles to *real* tonic when ``--cfg madsim``
is absent (madsim-tonic/src/lib.rs:1-8) — an app written against the shim
runs against real HTTP/2 without code changes.  This module is that
property for the Python framework: every piece of the sim gRPC stack
(service decorators, typed clients, the four call shapes, interceptors,
grpc-timeout, Status mapping, load-balanced channels) is reused verbatim;
only the executor bindings (asyncio instead of the deterministic scheduler)
and the transport (framed TCP streams, real/stream.py) are swapped::

    from madsim_tpu_torch import real
    from madsim_tpu_torch.real import grpc

    # server
    await grpc.Server.builder().add_service(Greeter()).serve("127.0.0.1:50051")
    # client
    channel = await grpc.Endpoint.from_static("http://127.0.0.1:50051").connect()
    client = grpc.ServiceClient(Greeter, channel)

Wire safety: frames use the restricted codec (real/codec.py), so only plain
data and registered classes travel.  The envelope types (Request, Response,
Status, Code) are registered here; user message classes must be registered
with ``real.codec.register`` (the analogue of deriving Serialize in the
reference — wire types are always declared explicitly).
"""

from __future__ import annotations

import random as _pyrandom
from typing import Any, Optional

from ..grpc import codec as _gcodec
from ..grpc.channel import Change, Channel as _SimChannel, Endpoint as _SimEndpoint
from ..grpc.client import Grpc as _SimGrpc, Request, Response
from ..grpc.codec import Streaming
from ..grpc.server import Router as _SimRouter, ServerBuilder as _SimServerBuilder
from ..grpc.service import (
    ServiceClient as _SimServiceClient,
    bidi_streaming,
    client_streaming,
    server_streaming,
    service,
    unary,
)
from ..grpc.status import Code, Status
from . import codec, stream
from . import time as rtime
from .runtime import spawn

# envelope types every call carries — registered once, like the serde
# derives on the reference's envelope structs
codec.register(Request)
codec.register(Response)
codec.register(Status)
codec.register(Code)


class Grpc(_SimGrpc):
    """The generic caller bound to asyncio (spawn/timeout swapped)."""

    _spawn = staticmethod(spawn)
    _timeout = staticmethod(rtime.timeout)
    _timeout_error = rtime.TimeoutError


class Channel(_SimChannel):
    """Load-balanced channel dialing real framed-TCP connections."""

    @staticmethod
    def _randint(n: int) -> int:
        return _pyrandom.randrange(n)  # real mode: real randomness

    async def _open(self, addr: str):
        try:
            return await stream.connect(addr)
        except (ConnectionError, OSError) as e:
            raise Status.unavailable(f"transport error: {e}") from None


class Endpoint(_SimEndpoint):
    """The tonic ``transport::Endpoint`` builder, real-mode flavor."""

    _channel_cls = Channel
    _timeout_fn = staticmethod(rtime.timeout)
    _timeout_error = rtime.TimeoutError


class ServiceClient(_SimServiceClient):
    """Typed client for a @service class over the real transport."""

    _grpc_cls = Grpc


class Router(_SimRouter):
    """The sim router/dispatcher serving on a real TCP listener.

    Connections are multiplexed by the shared serving core
    (``madsim_tpu_torch/serve/``); the per-connection dispatcher
    (``_serve_conn``) is unchanged, fed through a ``ChannelAdapter``.
    """

    _spawn = staticmethod(spawn)

    @staticmethod
    async def _bind(addr: "str | tuple") -> Any:
        return await stream.StreamListener.bind(addr)

    async def serve_with_shutdown(
        self, addr: "str | tuple", signal: "Any | None"
    ) -> None:
        import asyncio

        from ..serve import AsyncWireServer, ChannelAdapter

        adapter = ChannelAdapter(self._serve_conn, codec, name="grpc")
        self._core = AsyncWireServer(adapter)
        self.bound_addr = await self._core.start(addr)
        try:
            if signal is None:
                await self._core._stopped.wait()
            else:
                stop = asyncio.ensure_future(self._core._stopped.wait())
                sig = asyncio.ensure_future(signal)
                _done, pending = await asyncio.wait(
                    {stop, sig}, return_when=asyncio.FIRST_COMPLETED
                )
                for p in pending:
                    p.cancel()
        finally:
            self._core.close()
            self._core._teardown()


class ServerBuilder(_SimServerBuilder):
    _router_cls = Router


class Server:
    @staticmethod
    def builder() -> ServerBuilder:
        return ServerBuilder()


# --------------------------------------------------------------- grpcio
# The genuine-wire tier: the SAME protogen service classes served and
# called over actual gRPC (HTTP/2 + protobuf) via the installed grpcio,
# so a stock gRPC peer in any language interoperates. This is the full
# analogue of the reference's std mode being real tonic
# (madsim-tonic/src/lib.rs:1-8, madsim-tonic-build/src/prost.rs:599-680:
# the same app binary speaks to any gRPC ecosystem peer).
#
# Requires proto-derived services (``pkg.implement``/``pkg.stub``): real
# protobuf wire bytes need the per-method message classes that protogen
# attaches; hand-decorated @service classes have no message schema.

from ..grpc.service import (
    _IO_ATTR,
    _NAME_ATTR,
    _TABLE_ATTR,
    _WIRE_ATTR,
    camel as _camel,
)


def _grpc_mod():
    import grpc as grpcio  # deferred: real mode must import without grpcio

    return grpcio


def _to_status(e) -> Status:
    """Map a grpcio error (code, details) onto this framework's Status."""
    code = e.code()
    return Status(Code(code.value[0]), e.details() or "")


def _from_status_code(code: Code):
    grpcio = _grpc_mod()
    for sc in grpcio.StatusCode:
        if sc.value[0] == int(code):
            return sc
    return grpcio.StatusCode.UNKNOWN


def _io_table(service_cls: type) -> dict:
    io = getattr(service_cls, _IO_ATTR, None)
    if io is None:
        raise TypeError(
            f"{service_cls.__name__} carries no protobuf message types; "
            "the grpcio wire tier needs a proto-derived service "
            "(grpc.compile_protos(...).implement/stub), not a "
            "hand-decorated @service class"
        )
    return io


def _unwrap_msg(result: Any):
    """Handler return value -> raw protobuf message for the wire."""
    return result.message if isinstance(result, Response) else result


def _clean_metadata(md: dict) -> tuple:
    """User metadata for the wire; grpc-* keys are reserved headers that
    grpcio derives itself (timeout travels as the deadline)."""
    return tuple(
        (k.lower(), v) for k, v in md.items() if not k.lower().startswith("grpc-")
    )


class _RequestStream:
    """Server-side request stream: grpcio's request iterator behind the
    Streaming surface handlers already use (async-for / .message())."""

    def __init__(self, request_iterator):
        self._it = request_iterator.__aiter__()
        self._done = False

    async def message(self) -> Optional[Any]:
        if self._done:
            return None
        try:
            return await self._it.__anext__()
        except StopAsyncIteration:
            self._done = True
            return None

    def __aiter__(self) -> "_RequestStream":
        return self

    async def __anext__(self) -> Any:
        msg = await self.message()
        if msg is None:
            raise StopAsyncIteration
        return msg


class GrpcioStreaming:
    """Client-side response stream over a grpcio call object, with the
    Streaming surface (async-for / .message() / .close())."""

    def __init__(self, call):
        self._call = call
        self._it = call.__aiter__()
        self._done = False
        # captured once: resolving the module per streamed message would
        # put an import-machinery lookup on the hot read path
        self._rpc_error = _grpc_mod().aio.AioRpcError

    async def message(self) -> Optional[Any]:
        if self._done:
            return None
        try:
            return await self._it.__anext__()
        except StopAsyncIteration:
            self._done = True
            return None
        except self._rpc_error as e:
            self._done = True
            raise _to_status(e) from None

    def close(self) -> None:
        self._done = True
        self._call.cancel()

    def __aiter__(self) -> "GrpcioStreaming":
        return self

    async def __anext__(self) -> Any:
        msg = await self.message()
        if msg is None:
            raise StopAsyncIteration
        return msg


async def _aiter_messages(messages):
    """Message bodies may be sync/async iterables or an awaitable of one
    (same contract as the framed tier's _serve_stream); grpcio wants an
    async iterator of raw messages."""
    import inspect

    if inspect.iscoroutine(messages):
        messages = await messages
    if hasattr(messages, "__aiter__"):
        async for m in messages:
            yield _unwrap_msg(m)
    else:
        for m in messages:
            yield _unwrap_msg(m)


class GrpcioChannel:
    """A real gRPC channel (``grpc.aio.insecure_channel``) behind the
    minimal surface the typed client uses."""

    def __init__(self, target: str, default_timeout: Optional[float] = None):
        grpcio = _grpc_mod()
        self.target = target
        self.default_timeout = default_timeout
        self._ch = grpcio.aio.insecure_channel(target)

    async def close(self) -> None:
        await self._ch.close()


class GrpcioGrpc(Grpc):
    """The generic caller over real gRPC wire — the four call shapes are
    reimplemented on grpcio multicallables; ``_prepare`` (interceptor then
    default-timeout injection) is INHERITED from the one implementation in
    grpc/client.py so the three tiers cannot drift."""

    def __init__(self, channel: GrpcioChannel, interceptor=None,
                 service_cls: Optional[type] = None):
        super().__init__(channel, interceptor)
        self._io = _io_table(service_cls) if service_cls is not None else {}
        # literal proto method name -> snake (acronym-safe path resolution)
        wire = getattr(service_cls, _WIRE_ATTR, {}) if service_cls else {}
        self._wire_to_snake = {v: k for k, v in wire.items()}
        # multicallables are fixed per (shape, path) for the channel's
        # lifetime — build each once, like grpcio's generated stubs do
        self._mc_cache: dict = {}

    def with_interceptor(self, f) -> "GrpcioGrpc":
        g = GrpcioGrpc(self.channel, f)
        g._io = self._io
        g._wire_to_snake = self._wire_to_snake
        return g

    def _multicallable(self, shape: str, path: str):
        """The cached grpcio multicallable for one method path."""
        mc = self._mc_cache.get((shape, path))
        if mc is not None:
            return mc
        from ..grpc.protogen import _snake

        seg = path.rsplit("/", 1)[-1]
        snake = self._wire_to_snake.get(seg) or _snake(seg)
        io = self._io.get(snake)
        if io is None:
            raise TypeError(
                f"no protobuf message types known for {path!r}; grpcio "
                "calls need a proto-derived stub (pkg.stub/pkg.implement)"
            )
        _req_cls, rsp_cls = io
        mc = getattr(self.channel._ch, shape)(
            path,
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=rsp_cls.FromString,
        )
        self._mc_cache[(shape, path)] = mc
        return mc

    async def unary(self, path: str, request) -> Response:
        grpcio = _grpc_mod()
        request = self._prepare(Request.wrap(request))
        mc = self._multicallable("unary_unary", path)
        try:
            msg = await mc(
                _unwrap_msg(request.message),
                timeout=request.timeout(),
                metadata=_clean_metadata(request.metadata),
            )
        except grpcio.aio.AioRpcError as e:
            raise _to_status(e) from None
        return Response(msg)

    async def client_streaming(self, path: str, messages,
                               request: Optional[Request] = None) -> Response:
        grpcio = _grpc_mod()
        request = self._prepare(request or Request())
        mc = self._multicallable("stream_unary", path)
        try:
            msg = await mc(
                _aiter_messages(messages),
                timeout=request.timeout(),
                metadata=_clean_metadata(request.metadata),
            )
        except grpcio.aio.AioRpcError as e:
            raise _to_status(e) from None
        return Response(msg)

    async def _open_stream(self, call) -> GrpcioStreaming:
        """Surface call-setup failures (dead peer, unknown method) at the
        await, like the sim and framed tiers, instead of deferring the
        Status to the first message read."""
        grpcio = _grpc_mod()
        try:
            await call.wait_for_connection()
        except grpcio.aio.AioRpcError as e:
            raise _to_status(e) from None
        return GrpcioStreaming(call)

    async def server_streaming(self, path: str, request) -> GrpcioStreaming:
        request = self._prepare(Request.wrap(request))
        mc = self._multicallable("unary_stream", path)
        call = mc(
            _unwrap_msg(request.message),
            timeout=request.timeout(),
            metadata=_clean_metadata(request.metadata),
        )
        return await self._open_stream(call)

    async def streaming(self, path: str, messages,
                        request: Optional[Request] = None) -> GrpcioStreaming:
        request = self._prepare(request or Request())
        mc = self._multicallable("stream_stream", path)
        call = mc(
            _aiter_messages(messages),
            timeout=request.timeout(),
            metadata=_clean_metadata(request.metadata),
        )
        return await self._open_stream(call)


class GrpcioServiceClient(_SimServiceClient):
    """Typed client for a proto-derived service over real gRPC wire."""

    def __init__(self, service_cls: type, channel: GrpcioChannel,
                 interceptor=None):
        self._cls = service_cls
        self._name = getattr(service_cls, _NAME_ATTR)
        self._table = getattr(service_cls, _TABLE_ATTR)
        self._wire = getattr(service_cls, _WIRE_ATTR, {})
        self._grpc = GrpcioGrpc(channel, interceptor, service_cls)

    def _path(self, method: str) -> str:
        # the LITERAL descriptor method name: stock peers route by it, and
        # camel() does not round-trip acronyms (GetTPUInfo != GetTpuInfo)
        seg = self._wire.get(method) or _camel(method)
        return f"/{self._name}/{seg}"


class _GrpcioHandler:
    """Routes every inbound wire call to the registered service instances
    (a ``grpc.GenericRpcHandler``; the base class is resolved lazily so
    importing this module never requires grpcio)."""

    def __init__(self, services: dict):
        self._services = services  # full name -> instance

    def service(self, handler_call_details):
        grpcio = _grpc_mod()
        path = handler_call_details.method
        svc_name, _, method_path = path.strip("/").partition("/")
        svc = self._services.get(svc_name)
        if svc is None:
            return None  # grpcio answers UNIMPLEMENTED
        table = getattr(svc, _TABLE_ATTR, {})
        wire = getattr(svc, _WIRE_ATTR, {})
        snake = kind = None
        for name, k in table.items():
            if method_path in (name, _camel(name), wire.get(name)):
                snake, kind = name, k
                break
        if snake is None:
            return None
        io = _io_table(type(svc)).get(snake)
        if io is None:
            # matched the service but its message schema never resolved
            # (e.g. nested message types, which compile_protos does not
            # register): answer by NAME, not a bare UNIMPLEMENTED
            async def no_schema(msg, context):
                await context.abort(
                    grpcio.StatusCode.UNIMPLEMENTED,
                    f"method {path!r} exists on {svc_name} but its "
                    "protobuf message types were not among the compiled "
                    "messages (nested message types are not registered "
                    "by compile_protos)",
                )

            return grpcio.unary_unary_rpc_method_handler(no_schema)
        req_cls, _rsp_cls = io
        handler = getattr(svc, snake)
        deser = req_cls.FromString
        ser = lambda m: m.SerializeToString()  # noqa: E731

        async def _abort(context, st: Status):
            await context.abort(_from_status_code(st.code), st.message)

        if kind == "unary":
            async def behavior(msg, context):
                try:
                    result = await handler(_wire_request(msg, context))
                except Status as st:
                    await _abort(context, st)
                return _unwrap_msg(result)

            return grpcio.unary_unary_rpc_method_handler(
                behavior, request_deserializer=deser, response_serializer=ser
            )
        if kind == "server_streaming":
            async def behavior(msg, context):
                agen = handler(_wire_request(msg, context))
                try:
                    async for m in _aiter_messages(agen):
                        yield m
                except Status as st:
                    await _abort(context, st)

            return grpcio.unary_stream_rpc_method_handler(
                behavior, request_deserializer=deser, response_serializer=ser
            )
        if kind == "client_streaming":
            async def behavior(request_iterator, context):
                try:
                    result = await handler(_RequestStream(request_iterator))
                except Status as st:
                    await _abort(context, st)
                return _unwrap_msg(result)

            return grpcio.stream_unary_rpc_method_handler(
                behavior, request_deserializer=deser, response_serializer=ser
            )

        async def behavior(request_iterator, context):
            agen = handler(_RequestStream(request_iterator))
            try:
                async for m in _aiter_messages(agen):
                    yield m
            except Status as st:
                await _abort(context, st)

        return grpcio.stream_stream_rpc_method_handler(
            behavior, request_deserializer=deser, response_serializer=ser
        )


def _wire_request(msg, context) -> Request:
    """Inbound message + metadata as the Request envelope handlers see."""
    md = {k: v for k, v in (context.invocation_metadata() or ())
          if not isinstance(v, bytes)}
    return Request(msg, metadata=md)


class GrpcioRouter:
    """Serves proto-derived service instances via ``grpc.aio.server()``."""

    def __init__(self, builder: "GrpcioServerBuilder"):
        self._services = dict(builder._services)
        self.bound_addr: Optional[tuple] = None

    def _add(self, svc: Any) -> "GrpcioRouter":
        self._services[getattr(svc, _NAME_ATTR)] = svc
        _io_table(type(svc))  # fail at registration, not first call
        return self

    def add_service(self, svc: Any) -> "GrpcioRouter":
        return self._add(svc)

    async def serve(self, addr: "str | tuple") -> None:
        await self.serve_with_shutdown(addr, None)

    async def serve_with_shutdown(self, addr: "str | tuple",
                                  signal: Optional[Any]) -> None:
        grpcio = _grpc_mod()
        server = grpcio.aio.server()
        server.add_generic_rpc_handlers((_GrpcioHandler(self._services),))
        addr_str = addr if isinstance(addr, str) else f"{addr[0]}:{addr[1]}"
        port = server.add_insecure_port(addr_str)
        if port == 0:
            raise OSError(f"grpcio bind failed: {addr_str}")
        await server.start()
        self.bound_addr = (addr_str.rsplit(":", 1)[0], port)
        try:
            if signal is None:
                await server.wait_for_termination()
            else:
                await signal
        finally:
            await server.stop(None)


class GrpcioServerBuilder:
    def __init__(self) -> None:
        self._services: dict = {}

    def add_service(self, svc: Any) -> GrpcioRouter:
        return GrpcioRouter(self)._add(svc)


class GrpcioServer:
    """``Server``'s genuine-wire sibling: same builder surface, real gRPC."""

    @staticmethod
    def builder() -> GrpcioServerBuilder:
        return GrpcioServerBuilder()


__all__ = [
    "Change",
    "Channel",
    "Code",
    "Endpoint",
    "Grpc",
    "GrpcioChannel",
    "GrpcioGrpc",
    "GrpcioRouter",
    "GrpcioServer",
    "GrpcioServiceClient",
    "GrpcioStreaming",
    "Request",
    "Response",
    "Router",
    "Server",
    "ServerBuilder",
    "ServiceClient",
    "Status",
    "Streaming",
    "bidi_streaming",
    "client_streaming",
    "server_streaming",
    "service",
    "unary",
]
