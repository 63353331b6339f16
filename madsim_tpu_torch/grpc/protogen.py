"""``.proto`` ingestion for the gRPC shim — the madsim-tonic-build analogue.

The reference forks tonic's codegen so one ``.proto`` produces BOTH real
stubs and sim stubs (madsim-tonic-build/src/prost.rs:599-680: the sim
``ServiceGenerator`` writes into ``$OUT_DIR/sim/`` next to the real
tonic-build output). Python needs no build step, so the same capability
is a runtime call:

    pkg = grpc.compile_protos("helloworld.proto")

    HelloRequest = pkg.messages["helloworld.HelloRequest"]   # real protobufs

    @pkg.implement("helloworld.Greeter")                     # server side
    class Greeter:
        async def say_hello(self, request): ...              # kinds from the proto
        async def lots_of_replies(self, request): yield ...

    client = pkg.client("helloworld.Greeter", channel)       # typed client
    reply = (await client.say_hello(HelloRequest(name="x"))).into_inner()

``compile_protos`` shells out to ``protoc`` (baked into the image) for a
descriptor set + ``--python_out`` message modules: message classes are
REAL ``google.protobuf`` messages, method streaming kinds come from the
descriptor's client/server streaming flags, and the generated stubs speak
this shim's message protocol — so a user with an existing proto tree gets
clients/servers wired into the simulator without hand-decorating anything.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import re
import subprocess
import sys
import tempfile
from typing import Any, Callable, Dict, NamedTuple, Optional

# import the submodule's names directly: the package __init__ rebinds the
# `service` attribute to the decorator function, so `from . import
# service` would grab that instead of the module
from .service import (
    _IO_ATTR,
    _KIND_ATTR,
    _NAME_ATTR,
    _TABLE_ATTR,
    _WIRE_ATTR,
    ServiceClient,
    service as _service_decorator,
)
from .channel import Channel


class ProtogenError(Exception):
    """protoc failed or the descriptor set is unusable."""


# generated-module content seen per module name: recompiling a *modified*
# proto under the same filename must not silently hand back the first
# compile's stale classes (it would also mask descriptor-pool conflicts)
_COMPILED_SHA: Dict[str, str] = {}


class ServiceSpec(NamedTuple):
    full_name: str
    methods: Dict[str, str]  # python snake_case name -> call kind
    #: snake_case name -> (request type full name, response type full name);
    #: resolved to message classes on demand (grpcio interop needs them)
    io: Dict[str, tuple] = {}
    #: snake_case name -> literal proto method name (wire-path segment for
    #: stock-gRPC peers; camel() does not round-trip acronym names)
    wire: Dict[str, str] = {}


def _snake(name: str) -> str:
    """CamelCase proto method name -> python snake_case (tonic's mapping
    in reverse; ``service.camel`` round-trips it for the wire path)."""
    s = re.sub(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])", "_", name)
    return s.lower()


def _kind(method) -> str:
    if method.client_streaming and method.server_streaming:
        return "bidi_streaming"
    if method.client_streaming:
        return "client_streaming"
    if method.server_streaming:
        return "server_streaming"
    return "unary"


class ProtoPackage:
    """Everything one ``compile_protos`` call produced."""

    def __init__(self, services: Dict[str, ServiceSpec],
                 messages: Dict[str, type], modules: Dict[str, Any]):
        self.services = services
        self.messages = messages  # proto full name -> message class
        self.modules = modules  # generated module name -> module

    # -- server side --------------------------------------------------------

    def implement(self, full_name: str) -> Callable[[type], type]:
        """Class decorator: attach the proto-declared kind to each handler
        and register the service (the generated-server analogue). The
        class must define one ``async def`` per rpc, snake_case named."""
        spec = self._spec(full_name)

        def deco(cls: type) -> type:
            for snake, kind in spec.methods.items():
                fn = cls.__dict__.get(snake)
                if fn is None:
                    raise ProtogenError(
                        f"{cls.__name__} is missing rpc method {snake!r} "
                        f"declared by {full_name} in the proto"
                    )
                setattr(fn, _KIND_ATTR, kind)
            cls = _service_decorator(full_name)(cls)
            setattr(cls, _IO_ATTR, self._io_classes(spec))
            setattr(cls, _WIRE_ATTR, dict(spec.wire))
            return cls

        return deco

    # -- client side --------------------------------------------------------

    def client(self, full_name: str, channel: Channel,
               interceptor: Optional[Callable] = None) -> ServiceClient:
        """Typed client built from the proto alone — no server class
        needed in-process (the generated-client analogue)."""
        return ServiceClient(self.stub(full_name), channel, interceptor)

    def stub(self, full_name: str) -> type:
        """A class carrying the service's name, method table, and message
        types — what ``ServiceClient`` (sim or grpcio-backed) needs to
        derive a typed client without a server class in-process."""
        spec = self._spec(full_name)
        return type(
            spec.full_name.rsplit(".", 1)[-1] + "Stub",
            (),
            {
                _NAME_ATTR: spec.full_name,
                _TABLE_ATTR: dict(spec.methods),
                _IO_ATTR: self._io_classes(spec),
                _WIRE_ATTR: dict(spec.wire),
            },
        )

    def _io_classes(self, spec: ServiceSpec) -> Dict[str, tuple]:
        """snake method name -> (request class, response class). Methods
        whose types didn't resolve (e.g. nested message types) are
        omitted — the sim transport doesn't need them; the grpcio interop
        layer reports the gap by name if such a method is ever called."""
        out: Dict[str, tuple] = {}
        for snake, (req_name, rsp_name) in spec.io.items():
            req = self.messages.get(req_name)
            rsp = self.messages.get(rsp_name)
            if req is not None and rsp is not None:
                out[snake] = (req, rsp)
        return out

    def _spec(self, full_name: str) -> ServiceSpec:
        spec = self.services.get(full_name)
        if spec is None:
            known = ", ".join(sorted(self.services)) or "<none>"
            raise ProtogenError(
                f"unknown service {full_name!r}; protos defined: {known}"
            )
        return spec


def compile_protos(*protos: str, includes: tuple = ()) -> ProtoPackage:
    """Compile ``.proto`` files into a :class:`ProtoPackage`.

    Runs ``protoc`` twice-in-one: ``--descriptor_set_out`` (service and
    method metadata) and ``--python_out`` (real message classes, loaded
    from a temp dir and registered under their generated module names so
    cross-file imports in multi-proto trees resolve)."""
    proto_paths = [os.path.abspath(p) for p in protos]
    for p in proto_paths:
        if not os.path.exists(p):
            raise ProtogenError(f"no such proto file: {p}")
    inc = {os.path.dirname(p) for p in proto_paths}
    inc.update(os.path.abspath(i) for i in includes)

    with tempfile.TemporaryDirectory() as tmp:
        ds_path = os.path.join(tmp, "descriptors.pb")
        cmd = [
            "protoc",
            f"--descriptor_set_out={ds_path}",
            "--include_imports",
            f"--python_out={tmp}",
            *[f"-I{i}" for i in sorted(inc)],
            *proto_paths,
        ]
        run = subprocess.run(cmd, capture_output=True, text=True)
        if run.returncode != 0:
            raise ProtogenError(f"protoc failed:\n{run.stderr.strip()}")

        from google.protobuf import descriptor_pb2

        ds = descriptor_pb2.FileDescriptorSet()
        with open(ds_path, "rb") as f:
            ds.ParseFromString(f.read())

        modules: Dict[str, Any] = {}
        services: Dict[str, ServiceSpec] = {}
        messages: Dict[str, type] = {}
        for fd in ds.file:
            mod_name = fd.name[: -len(".proto")].replace("/", ".").replace(
                "-", "_"
            ) + "_pb2"
            mod_path = os.path.join(tmp, fd.name[: -len(".proto")] + "_pb2.py")
            if os.path.exists(mod_path):
                with open(mod_path, "rb") as f:
                    sha = hashlib.sha256(f.read()).hexdigest()
                if mod_name in sys.modules:
                    prev = _COMPILED_SHA.get(mod_name)
                    if prev is None:
                        # loaded outside compile_protos (e.g. an installed
                        # _pb2): trust it only if its descriptor bytes match
                        # what protoc just generated
                        loaded = sys.modules[mod_name]
                        ser = getattr(
                            getattr(loaded, "DESCRIPTOR", None),
                            "serialized_pb",
                            None,
                        )
                        # compare parsed messages, not bytes: a different
                        # protoc release can serialize the same descriptor
                        # with different bytes
                        same = ser is not None and (
                            descriptor_pb2.FileDescriptorProto.FromString(ser)
                            == fd
                        )
                        if not same:
                            raise ProtogenError(
                                f"module {mod_name!r} is already loaded with "
                                f"a different descriptor than {fd.name!r} "
                                "compiles to; rename the file or restart — "
                                "protobuf's descriptor pool cannot hold two "
                                "versions of one file"
                            )
                        _COMPILED_SHA[mod_name] = sha
                    elif prev != sha:
                        raise ProtogenError(
                            f"proto {fd.name!r} changed since it was first "
                            f"compiled in this process (module {mod_name!r} "
                            "is already loaded with different contents); "
                            "rename the file or restart the process — "
                            "protobuf's descriptor pool cannot hold two "
                            "versions of one file"
                        )
                    modules[mod_name] = sys.modules[mod_name]
                else:
                    spec = importlib.util.spec_from_file_location(
                        mod_name, mod_path
                    )
                    module = importlib.util.module_from_spec(spec)
                    # registered BEFORE exec so sibling _pb2 imports resolve
                    sys.modules[mod_name] = module
                    try:
                        spec.loader.exec_module(module)
                    except Exception:
                        del sys.modules[mod_name]
                        raise
                    _COMPILED_SHA[mod_name] = sha
                    modules[mod_name] = module
            elif mod_name in sys.modules:
                modules[mod_name] = sys.modules[mod_name]

            pkg = fd.package
            module = modules.get(mod_name)
            for msg in fd.message_type:
                full = f"{pkg}.{msg.name}" if pkg else msg.name
                if module is not None and hasattr(module, msg.name):
                    messages[full] = getattr(module, msg.name)
            for svc in fd.service:
                full = f"{pkg}.{svc.name}" if pkg else svc.name
                services[full] = ServiceSpec(
                    full_name=full,
                    methods={_snake(m.name): _kind(m) for m in svc.method},
                    # descriptor type refs are ".pkg.Msg"-qualified
                    io={
                        _snake(m.name): (
                            m.input_type.lstrip("."),
                            m.output_type.lstrip("."),
                        )
                        for m in svc.method
                    },
                    wire={_snake(m.name): m.name for m in svc.method},
                )

        return ProtoPackage(services, messages, modules)
