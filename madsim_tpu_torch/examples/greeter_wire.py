"""The greeter over GENUINE gRPC wire (HTTP/2 + protobuf via grpcio) —
the same proto-derived service class the simulator serves, reachable by
any stock gRPC client in any language (docs/real_mode.md; the analogue
of the reference's std mode being real tonic, madsim-tonic/src/lib.rs:1-8).

Run:  python -m madsim_tpu_torch.examples.greeter_wire

The port's own copy of the repository's ``examples/greeter_wire.py``.

Demonstrates both sides: the madsim GrpcioServer serving, then (a) the
madsim typed client and (b) a stock grpcio multicallable client — what
grpcio's generated stubs expand to — calling it over the real wire.
"""

from __future__ import annotations

import os
import tempfile

from madsim_tpu_torch import real
from madsim_tpu_torch.grpc import protogen
from madsim_tpu_torch.real import grpc

PROTO = """
syntax = "proto3";
package greeterwire;
message HelloRequest { string name = 1; }
message HelloReply { string message = 1; }
service Greeter {
  rpc SayHello (HelloRequest) returns (HelloReply);
  rpc LotsOfReplies (HelloRequest) returns (stream HelloReply);
}
"""


def build_pkg() -> protogen.ProtoPackage:
    d = tempfile.mkdtemp(prefix="greeter_wire")
    path = os.path.join(d, "greeterwire.proto")
    with open(path, "w") as f:
        f.write(PROTO)
    return protogen.compile_protos(path)


def make_greeter(pkg):
    HelloReply = pkg.messages["greeterwire.HelloReply"]

    @pkg.implement("greeterwire.Greeter")
    class Greeter:
        async def say_hello(self, request):
            return HelloReply(message=f"Hello {request.message.name}!")

        async def lots_of_replies(self, request):
            for i in range(3):
                yield HelloReply(message=f"{i}: Hello {request.message.name}!")

    return Greeter


async def main() -> None:
    pkg = build_pkg()
    HelloRequest = pkg.messages["greeterwire.HelloRequest"]
    HelloReply = pkg.messages["greeterwire.HelloReply"]

    # serve on an OS-assigned port
    router = grpc.GrpcioServer.builder().add_service(make_greeter(pkg)())
    serve = real.spawn(router.serve(("127.0.0.1", 0)))
    while router.bound_addr is None:
        if serve.done():
            serve.result()
        await real.sleep(0.005)
    host, port = router.bound_addr
    addr = f"{host}:{port}"
    print(f"serving genuine gRPC on {addr}")

    # (a) the madsim typed client over the real wire
    channel = grpc.GrpcioChannel(addr)
    client = grpc.GrpcioServiceClient(pkg.stub("greeterwire.Greeter"), channel)
    reply = await client.say_hello(HelloRequest(name="wire"))
    print("typed client:", reply.into_inner().message)
    stream = await client.lots_of_replies(HelloRequest(name="stream"))
    async for r in stream:
        print("typed client stream:", r.message)
    await channel.close()

    # (b) a STOCK grpcio client — no madsim code on this side
    from grpc import aio as grpc_aio

    async with grpc_aio.insecure_channel(addr) as ch:
        say_hello = ch.unary_unary(
            "/greeterwire.Greeter/SayHello",
            request_serializer=HelloRequest.SerializeToString,
            response_deserializer=HelloReply.FromString,
        )
        reply = await say_hello(HelloRequest(name="stock"))
        print("stock client:", reply.message)

    serve.abort()


if __name__ == "__main__":
    real.Runtime().block_on(main())
