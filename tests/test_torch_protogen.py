"""Port parity: ``.proto`` ingestion (``madsim_tpu_torch.grpc.protogen``) —
the port of the reference's ``tests/test_protogen.py``.

``compile_protos`` runs ``protoc`` and loads real protobuf message
classes into protobuf's one process-wide descriptor pool, which cannot
hold two versions of one file. So each package compiles its own file
(``echotest_ref.proto`` / ``echotest_port.proto``, packages
``echotest_ref`` / ``echotest_port``) and the results are compared with
the package name taken out. The in-sim test runs one program through
both packages' ``Runtime(seed)`` with equal determinism logs, virtual
time and outputs. Skipped where ``protoc`` or ``google.protobuf`` is
missing.
"""

import os
import shutil
import tempfile

import pytest

import madsim_tpu as R
import madsim_tpu_torch as P
from _torch_parity import both, sub

pytestmark = pytest.mark.skipif(
    shutil.which("protoc") is None, reason="protoc is not on PATH"
)
pytest.importorskip("google.protobuf")

PROTO = """
syntax = "proto3";
package echotest_{tag};

message EchoRequest {{ string text = 1; int32 n = 2; }}
message EchoReply   {{ string text = 1; }}

service Echo {{
  rpc Say (EchoRequest) returns (EchoReply);
  rpc Fan (EchoRequest) returns (stream EchoReply);
  rpc Sum (stream EchoRequest) returns (EchoReply);
  rpc Chat (stream EchoRequest) returns (stream EchoReply);
}}
"""


def tag(ms) -> str:
    return "ref" if ms is R else "port"


def compile_for(ms, text=None):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"echotest_{tag(ms)}.proto")
        with open(path, "w") as f:
            f.write(PROTO.format(tag=tag(ms)) if text is None else text)
        return sub(ms, "grpc").compile_protos(path)


def untagged(ms, text: str) -> str:
    return text.replace(f"echotest_{tag(ms)}", "echotest")


def test_descriptor_parsing():
    got = []
    for ms in (R, P):
        pkg = compile_for(ms)
        svc = pkg.services[f"echotest_{tag(ms)}.Echo"]
        assert svc.methods == {"say": "unary", "fan": "server_streaming",
                               "sum": "client_streaming", "chat": "bidi_streaming"}
        cls = pkg.messages[f"echotest_{tag(ms)}.EchoRequest"]
        req = cls(text="hi", n=3)
        assert cls.FromString(req.SerializeToString()).text == "hi"
        got.append((svc.methods, svc.wire, sorted(untagged(ms, m) for m in pkg.messages),
                    req.SerializeToString()))
    assert got[0] == got[1]


def test_proto_service_all_modes_in_sim():
    pkgs = {ms: compile_for(ms) for ms in (R, P)}

    def implement(ms, pkg):
        EchoReply = pkg.messages[f"echotest_{tag(ms)}.EchoReply"]

        @pkg.implement(f"echotest_{tag(ms)}.Echo")
        class Echo:
            async def say(self, request):
                return EchoReply(text=f"say:{request.message.text}")

            async def fan(self, request):
                msg = request.message
                for i in range(msg.n):
                    yield EchoReply(text=f"fan{i}:{msg.text}")

            async def sum(self, stream):
                return EchoReply(text="+".join([m.text async for m in stream]))

            async def chat(self, stream):
                async for m in stream:
                    yield EchoReply(text=f"re:{m.text}")

        return Echo

    services = {ms: implement(ms, pkg) for ms, pkg in pkgs.items()}

    async def program(ms):
        grpc, pkg, Echo = sub(ms, "grpc"), pkgs[ms], services[ms]
        EchoRequest = pkg.messages[f"echotest_{tag(ms)}.EchoRequest"]
        h = ms.current_handle()
        addr = "10.0.0.1:700"
        h.create_node().name("server").ip("10.0.0.1").init(
            lambda: grpc.Server.builder().add_service(Echo()).serve(addr)).build()
        client_node = h.create_node().name("client").ip("10.0.0.2").build()
        await ms.sleep(0.1)

        async def run():
            channel = await grpc.Endpoint.from_static(f"http://{addr}").connect()
            c = pkg.client(f"echotest_{tag(ms)}.Echo", channel)
            out = [(await c.say(EchoRequest(text="x"))).into_inner().text]
            out.append([m.text async for m in await c.fan(EchoRequest(text="y", n=3))])
            out.append((await c.sum([EchoRequest(text=t) for t in "abc"])).into_inner().text)
            out.append([m.text async for m in await c.chat([EchoRequest(text=t) for t in "uv"])])
            assert out == ["say:x", ["fan0:y", "fan1:y", "fan2:y"], "a+b+c", ["re:u", "re:v"]]
            return out

        return await client_node.spawn(run())

    ref = both(program, 21)
    assert ref["draws"] > 0


def test_unknown_service_and_missing_method_error():
    msgs = []
    for ms in (R, P):
        grpc, pkg = sub(ms, "grpc"), compile_for(ms)
        with pytest.raises(grpc.ProtogenError, match="unknown service") as e1:
            pkg.client(f"echotest_{tag(ms)}.Nope", channel=None)
        with pytest.raises(grpc.ProtogenError, match="missing rpc method") as e2:

            @pkg.implement(f"echotest_{tag(ms)}.Echo")
            class Incomplete:
                async def say(self, request):
                    return None

        msgs.append([untagged(ms, str(e.value)) for e in (e1, e2)])
    assert msgs[0] == msgs[1]


def test_modified_proto_same_filename_errors_not_stale():
    """Recompiling a changed proto under the same file name raises; an
    unchanged recompile reuses the cached module quietly."""
    for ms in (R, P):
        grpc = sub(ms, "grpc")
        pkg = compile_for(ms)
        fields = pkg.messages[f"echotest_{tag(ms)}.EchoRequest"].DESCRIPTOR.fields
        assert "n" in {f.name for f in fields}
        changed = PROTO.format(tag=tag(ms)).replace("int32 n = 2;", "int32 n = 2; bool extra = 3;")
        with pytest.raises(grpc.ProtogenError, match="changed since"):
            compile_for(ms, changed)
        again = compile_for(ms)
        assert again.messages[f"echotest_{tag(ms)}.EchoRequest"] is pkg.messages[
            f"echotest_{tag(ms)}.EchoRequest"]


def test_bad_proto_reports_protoc_error():
    msgs = []
    for ms in (R, P):
        grpc = sub(ms, "grpc")
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "bad.proto")
            with open(path, "w") as f:
                f.write('syntax = "proto3";\nmessage Broken {')
            with pytest.raises(grpc.ProtogenError, match="protoc failed") as e1:
                grpc.compile_protos(path)
            bad = str(e1.value).replace(d, "<dir>")
        with pytest.raises(grpc.ProtogenError, match="no such proto") as e2:
            grpc.compile_protos("/nonexistent/x.proto")
        msgs.append([bad, str(e2.value)])
    assert msgs[0] == msgs[1]
