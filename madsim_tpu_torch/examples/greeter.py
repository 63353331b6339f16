"""The greeter service on the port's gRPC shim (the port's own copy of
``examples/greeter.py``, itself a port of the reference's end-to-end gRPC
app, tonic-example/src/lib.rs:22-123): unary with delay + error paths,
server streaming, client streaming, and bidirectional streaming.

Used by tests/test_torch_shims.py and runnable standalone:
``python -m madsim_tpu_torch.examples.greeter``
"""

from __future__ import annotations

from dataclasses import dataclass

import madsim_tpu_torch as ms
from madsim_tpu_torch import grpc


@dataclass
class HelloRequest:
    name: str
    delay_s: float = 0.0


@dataclass
class HelloReply:
    message: str


@grpc.service("helloworld.Greeter")
class Greeter:
    """The test service (ref tonic-example/src/lib.rs:22-123)."""

    @grpc.unary
    async def say_hello(self, request: grpc.Request) -> HelloReply:
        msg: HelloRequest = request.message
        if msg.delay_s:
            await ms.sleep(msg.delay_s)
        if msg.name == "error":
            raise grpc.Status.invalid_argument("invalid name: error")
        return HelloReply(message=f"Hello {msg.name}!")

    @grpc.server_streaming
    async def lots_of_replies(self, request: grpc.Request):
        msg: HelloRequest = request.message
        for i in range(3):
            await ms.sleep(0.1)
            yield HelloReply(message=f"{i}: Hello {msg.name}!")

    @grpc.client_streaming
    async def lots_of_greetings(self, stream: grpc.Streaming) -> HelloReply:
        names = []
        async for msg in stream:
            names.append(msg.name)
        return HelloReply(message=f"Hello {', '.join(names)}!")

    @grpc.bidi_streaming
    async def bidi_hello(self, stream: grpc.Streaming):
        async for msg in stream:
            yield HelloReply(message=f"Hello {msg.name}!")


async def serve(addr: str = "10.0.0.1:50051") -> None:
    await grpc.Server.builder().add_service(Greeter()).serve(addr)


async def demo() -> None:
    h = ms.current_handle()
    h.create_node().name("server").ip("10.0.0.1").init(lambda: serve()).build()
    client = h.create_node().name("client").ip("10.0.0.2").build()

    async def run_client():
        channel = await grpc.Endpoint.from_static("http://10.0.0.1:50051").connect()
        c = grpc.ServiceClient(Greeter, channel)
        reply = await c.say_hello(HelloRequest(name="world"))
        print("unary:", reply.into_inner().message)
        stream = await c.lots_of_replies(HelloRequest(name="stream"))
        async for r in stream:
            print("server-stream:", r.message)

    await ms.sleep(0.1)
    await client.spawn(run_client())


if __name__ == "__main__":
    ms.Runtime(seed=1).block_on(demo())
