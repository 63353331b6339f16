"""Built-in tag-matching RPC (ref madsim/src/sim/net/rpc.rs:73-167) and the
``@service`` class decorator (ref madsim-macros ``#[madsim::service]``,
madsim-macros/src/service.rs:60-109).

A *request type* carries a stable 64-bit ID derived from its qualified name
(the analogue of ``#[derive(Request)]``'s const ``hash_str(module_path +
name)``, madsim-macros/src/request.rs:60-66 + rpc.rs:82-92).  ``call`` sends
``(rsp_tag=random u64, req, data)`` on ``tag=ID`` and awaits ``rsp_tag``
(rpc.rs:108-131); ``add_rpc_handler`` spawns an accept loop plus one task
per request (rpc.rs:134-166).
"""

from __future__ import annotations

import hashlib
from typing import Any, Awaitable, Callable, Optional, Tuple, TYPE_CHECKING

from ..context import current_handle
from ..task import spawn
from ..time import timeout as _timeout

if TYPE_CHECKING:
    from .endpoint import Endpoint
    from .network import Addr


def hash_str(s: str) -> int:
    """Stable 64-bit id from a string (ref const ``hash_str``, rpc.rs:82-92)."""
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "little")


_REQUEST_TYPES: dict = {}


def request_types() -> dict:
    """Live registry of every defined Request subclass, keyed by qualified
    name — the set of user types the real-mode codec may materialize
    (real/codec.py). Never triggers an import."""
    return _REQUEST_TYPES


class Request:
    """Base class for RPC request types (``#[derive(Request)]`` analogue).

    Subclassing assigns a stable ``RPC_ID`` from the qualified class name
    and registers the type for the real-mode wire codec.
    Set class attr ``Response`` for documentation purposes (untyped here).
    """

    RPC_ID: int = 0
    Response: type = object

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        cls.RPC_ID = hash_str(f"{cls.__module__}::{cls.__qualname__}")
        _REQUEST_TYPES[f"{cls.__module__}::{cls.__qualname__}"] = cls


def request_id(req: Any) -> int:
    rid = getattr(type(req), "RPC_ID", None) or getattr(req, "RPC_ID", None)
    if not rid:
        raise TypeError(
            f"{type(req).__name__} is not a Request (subclass "
            f"madsim_tpu_torch.net.rpc.Request or define RPC_ID)"
        )
    return rid


# -- client side (rpc.rs:108-131) ------------------------------------------


async def call_with_data(
    ep: "Endpoint", dst: "str | Addr", req: Any, data: bytes
) -> Tuple[Any, bytes]:
    rsp_tag = current_handle().rng.next_u64()
    await ep.send_to_raw(
        dst, request_id(req), (rsp_tag, req, data), kind="rpc_req"
    )
    payload, _src = await ep.recv_from_raw(rsp_tag)
    rsp, rsp_data = payload
    return rsp, rsp_data


async def call(ep: "Endpoint", dst: "str | Addr", req: Any) -> Any:
    rsp, _data = await call_with_data(ep, dst, req, b"")
    return rsp


async def call_timeout(
    ep: "Endpoint", dst: "str | Addr", req: Any, timeout_s: float
) -> Any:
    return await _timeout(timeout_s, call(ep, dst, req))


# -- server side (rpc.rs:134-166) ------------------------------------------


def add_rpc_handler_with_data(
    ep: "Endpoint",
    req_type: type,
    handler: Callable[[Any, bytes], Awaitable[Tuple[Any, bytes]]],
) -> None:
    rid = request_id(req_type)

    async def accept_loop() -> None:
        while True:
            payload, src = await ep.recv_from_raw(rid)
            rsp_tag, req, data = payload

            async def handle_one(
                rsp_tag: int = rsp_tag, req: Any = req,
                data: bytes = data, src: "Addr" = src,
            ) -> None:
                rsp, rsp_data = await handler(req, data)
                await ep.send_to_raw(src, rsp_tag, (rsp, rsp_data), kind="rpc_rsp")

            spawn(handle_one(), name=f"rpc-{req_type.__name__}")

    spawn(accept_loop(), name=f"rpc-loop-{req_type.__name__}")


def add_rpc_handler(
    ep: "Endpoint", req_type: type, handler: Callable[[Any], Awaitable[Any]]
) -> None:
    async def with_data(req: Any, _data: bytes) -> Tuple[Any, bytes]:
        return await handler(req), b""

    add_rpc_handler_with_data(ep, req_type, with_data)


# -- @service / @rpc decorators (#[madsim::service] analogue) --------------


def rpc_method(req_type: type) -> Callable:
    """Mark a method as the handler for ``req_type``
    (ref ``#[rpc]``, madsim-macros/src/service.rs)."""

    def deco(method: Callable) -> Callable:
        method._rpc_request_type = req_type  # type: ignore[attr-defined]
        return method

    return deco


#: alias matching the reference's ``#[rpc]`` attribute name; import it from
#: ``madsim_tpu_torch.net.rpc`` (the package re-exports ``rpc_method`` to avoid
#: shadowing this module's name)
rpc = rpc_method


def service(cls: type) -> type:
    """Add ``serve(endpoint)`` registering every ``@rpc`` method
    (ref generated ``serve``/``serve_on``, service.rs:60-109)."""

    handlers = [
        (name, m._rpc_request_type)
        for name, m in vars(cls).items()
        if callable(m) and hasattr(m, "_rpc_request_type")
    ]

    def serve(self: Any, ep: "Endpoint") -> None:
        for name, req_type in handlers:
            bound = getattr(self, name)

            async def h(req: Any, _bound: Callable = bound) -> Any:
                return await _bound(req)

            add_rpc_handler(ep, req_type, h)

    cls.serve = serve  # type: ignore[attr-defined]
    return cls
