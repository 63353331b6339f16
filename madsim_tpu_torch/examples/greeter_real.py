"""The greeter service on REAL sockets — the same service class the
port's ``examples/greeter.py`` runs inside the simulator, served over
framed TCP with no simulator involved (docs/real_mode.md; the analogue of
building the reference without `--cfg madsim`). The port's own copy of
the repository's ``examples/greeter_real.py``.

Run:  python -m madsim_tpu_torch.examples.greeter_real
"""

from __future__ import annotations

from dataclasses import dataclass

from madsim_tpu_torch import real
from madsim_tpu_torch.real import grpc


@real.codec.register
@dataclass
class HelloRequest:
    name: str
    delay_s: float = 0.0


@real.codec.register
@dataclass
class HelloReply:
    message: str


@grpc.service("helloworld.Greeter")
class Greeter:
    """Identical shape to the sim example — write once, run both modes."""

    @grpc.unary
    async def say_hello(self, request: grpc.Request) -> HelloReply:
        msg: HelloRequest = request.message
        if msg.delay_s:
            await real.sleep(msg.delay_s)
        if msg.name == "error":
            raise grpc.Status.invalid_argument("invalid name: error")
        return HelloReply(message=f"Hello {msg.name}!")

    @grpc.server_streaming
    async def lots_of_replies(self, request: grpc.Request):
        for i in range(3):
            yield HelloReply(message=f"{i}: Hello {request.message.name}!")

    @grpc.client_streaming
    async def lots_of_greetings(self, stream: grpc.Streaming) -> HelloReply:
        names = [m.name async for m in stream]
        return HelloReply(message=f"Hello {', '.join(names)}!")

    @grpc.bidi_streaming
    async def bidi_hello(self, stream: grpc.Streaming):
        async for m in stream:
            yield HelloReply(message=f"Hello {m.name}!")


async def demo() -> None:
    router = grpc.Server.builder().add_service(Greeter())
    serve = real.spawn(router.serve(("127.0.0.1", 0)))
    while router.bound_addr is None:
        if serve.done():
            serve.result()
        await real.sleep(0.005)
    addr = "%s:%d" % router.bound_addr
    print(f"serving on {addr} (real TCP)")

    channel = await grpc.Endpoint.from_static(f"http://{addr}").connect()
    client = grpc.ServiceClient(Greeter, channel)

    print("unary:", (await client.say_hello(HelloRequest(name="world"))).into_inner().message)
    stream = await client.lots_of_replies(HelloRequest(name="stream"))
    async for r in stream:
        print("server-stream:", r.message)
    reply = await client.lots_of_greetings(
        [HelloRequest(name="a"), HelloRequest(name="b"), HelloRequest(name="c")]
    )
    print("client-stream:", reply.into_inner().message)
    bidi = await client.bidi_hello([HelloRequest(name="x"), HelloRequest(name="y")])
    async for r in bidi:
        print("bidi:", r.message)
    try:
        await client.say_hello(HelloRequest(name="error"))
    except grpc.Status as e:
        print("error path:", e.code.name, "-", e.message)
    serve.abort()


if __name__ == "__main__":
    real.Runtime().block_on(demo())
