"""gRPC simulation shim — the madsim-tonic analogue.

The reference intercepts tonic (Rust gRPC) with a message-passing protocol
over simulated connections (madsim-tonic/src/client.rs:33-38): a request is
``(path, server_streaming, Request)``, streamed bodies travel as raw
messages, and ``()`` marks end-of-stream. This package is the same design
Python-native:

- :mod:`status` — ``Code`` + ``Status`` (the error surface of gRPC)
- :mod:`channel` — transport ``Endpoint`` builder and ``Channel`` with
  random load balancing over static (``balance_list``) or dynamic
  (``balance_channel``) endpoint sets (transport/channel.rs:228-359)
- :mod:`server` — ``Server.builder().add_service(...).serve[_with_shutdown]``
  routing by service name with an Unimplemented fallback
  (transport/server.rs:210-335)
- :mod:`client` — generic ``Grpc`` caller: unary / client-streaming /
  server-streaming / bidi + interceptors + grpc-timeout
  (client.rs:39-219)
- :mod:`service` — decorators that play the role of tonic-build codegen
  (``@service`` + ``@unary``/``@server_streaming``/…), generating both the
  server routing table and a typed client (madsim-tonic-build/src/).
"""

from .status import Code, Status
from .codec import Streaming
from .channel import Change, Channel, Endpoint
from .server import Server
from .client import Grpc, Request, Response
from .service import (
    ServiceClient,
    bidi_streaming,
    client_streaming,
    server_streaming,
    service,
    unary,
)
from .protogen import ProtoPackage, ProtogenError, compile_protos

__all__ = [
    "Change",
    "Channel",
    "Code",
    "Endpoint",
    "Grpc",
    "ProtoPackage",
    "ProtogenError",
    "Request",
    "Response",
    "Server",
    "ServiceClient",
    "Status",
    "Streaming",
    "bidi_streaming",
    "client_streaming",
    "compile_protos",
    "server_streaming",
    "service",
    "unary",
]
