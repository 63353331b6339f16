"""Service definition decorators + typed client — the codegen analogue.

The reference generates sim clients/servers from .proto files with a forked
tonic-build (madsim-tonic-build/src/{client,server}.rs). A Python framework
needs no build step: decorate a class and its handler methods, and
``ServiceClient`` derives the typed client with the right call shape per
method:

    @grpc.service("helloworld.Greeter")
    class Greeter:
        @grpc.unary
        async def say_hello(self, request): ...
        @grpc.server_streaming
        async def lots_of_replies(self, request): yield ...
        @grpc.client_streaming
        async def lots_of_greetings(self, stream): ...
        @grpc.bidi_streaming
        async def bidi_hello(self, stream): yield ...

    client = grpc.ServiceClient(Greeter, channel)
    reply = (await client.say_hello(HelloRequest(...))).into_inner()

Paths are ``/<service>/<Method>`` with tonic's CamelCase method segment, so
routing matches what the reference's generated code produces.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from .channel import Channel
from .status import Status

_KIND_ATTR = "__grpc_kind__"
_NAME_ATTR = "__grpc_service_name__"
_TABLE_ATTR = "__grpc_methods__"
# protogen-attached: snake method name -> (request message class, response
# message class). Only proto-derived services carry it; the grpcio interop
# layer (real/grpc.py) needs it for wire serialization.
_IO_ATTR = "__grpc_io__"
# protogen-attached: snake method name -> the LITERAL proto method name.
# camel() does not round-trip acronym names (GetTPUInfo -> get_tpu_info ->
# GetTpuInfo), and a stock gRPC peer uses the descriptor's literal name in
# the wire path, so the grpcio tier must too.
_WIRE_ATTR = "__grpc_wire_names__"


def camel(snake: str) -> str:
    return "".join(p.title() for p in snake.split("_"))


def unary(fn: Callable) -> Callable:
    setattr(fn, _KIND_ATTR, "unary")
    return fn


def client_streaming(fn: Callable) -> Callable:
    setattr(fn, _KIND_ATTR, "client_streaming")
    return fn


def server_streaming(fn: Callable) -> Callable:
    setattr(fn, _KIND_ATTR, "server_streaming")
    return fn


def bidi_streaming(fn: Callable) -> Callable:
    setattr(fn, _KIND_ATTR, "bidi_streaming")
    return fn


def service(name: str) -> Callable[[type], type]:
    """Class decorator: registers the gRPC service name + method table."""

    def deco(cls: type) -> type:
        table: Dict[str, str] = {}
        for attr in dir(cls):
            v = getattr(cls, attr, None)
            kind = getattr(v, _KIND_ATTR, None)
            if kind is not None:
                table[attr] = kind
        setattr(cls, _NAME_ATTR, name)
        setattr(cls, _TABLE_ATTR, table)
        return cls

    return deco


def service_name(svc: Any) -> str:
    name = getattr(svc, _NAME_ATTR, None)
    if name is None:
        raise TypeError(f"{type(svc).__name__} is not a @grpc.service class")
    return name


def method_table(svc: Any) -> Dict[str, str]:
    return getattr(svc, _TABLE_ATTR, {})


class ServiceClient:
    """Typed client for a @service class (the generated-client analogue).

    Every decorated method becomes an attribute with the matching call
    shape; unary/server-streaming take a message (or Request),
    client-streaming/bidi take an iterable or async iterable of messages.
    """

    _grpc_cls: "type | None" = None  # real/grpc.py overrides

    def __init__(self, service_cls: type, channel: Channel,
                 interceptor: Optional[Callable] = None):
        from .client import Grpc

        self._cls = service_cls
        self._name = getattr(service_cls, _NAME_ATTR)
        self._table = getattr(service_cls, _TABLE_ATTR)
        self._grpc = (type(self)._grpc_cls or Grpc)(channel, interceptor)

    @classmethod
    def with_interceptor(cls, service_cls: type, channel: Channel,
                         interceptor: Callable) -> "ServiceClient":
        return cls(service_cls, channel, interceptor)

    def _path(self, method: str) -> str:
        return f"/{self._name}/{camel(method)}"

    def __getattr__(self, method: str) -> Callable:
        kind = self._table.get(method)
        if kind is None:
            raise AttributeError(f"{self._name} has no rpc method {method!r}")
        path = self._path(method)
        grpc = self._grpc
        if kind == "unary":
            return lambda msg: grpc.unary(path, msg)
        if kind == "server_streaming":
            return lambda msg: grpc.server_streaming(path, msg)
        if kind == "client_streaming":
            return lambda msgs: grpc.client_streaming(path, msgs)
        return lambda msgs: grpc.streaming(path, msgs)
