"""Real-mode S3 twin: the unchanged SDK-shaped client + the S3Service
state machine over real TCP (the dual-mode property of
madsim-aws-sdk-s3/src/lib.rs:3-10 — sim and production share one API)::

    from madsim_tpu_torch.real import s3

    await s3.SimServer().serve(("127.0.0.1", 9000))    # server task
    client = s3.Client.from_addr("127.0.0.1:9000")     # client side
    await client.put_object().bucket("b").key("k").body(b"...").send()
"""

from __future__ import annotations

import time as _walltime
from typing import Any

from ..s3.client import (
    ByteStream,
    Client as _SimClient,
    CompletedMultipartUpload,
    CompletedPart,
    Delete,
    ObjectIdentifier,
)
from ..s3.server import SimServer as _SimServer
from ..s3.service import S3Error, S3Service
from . import codec, stream
from .runtime import spawn


class SimServer(_SimServer):
    """The S3Service dispatcher on a real listener, wall-clock mtimes.

    Serving rides the shared core (``madsim_tpu_torch/serve/``) through a
    ``ChannelAdapter``: the one-exchange ``_serve_conn(tx, rx)``
    dispatcher is unchanged."""

    _spawn = staticmethod(spawn)

    @staticmethod
    async def _bind(addr: "str | tuple") -> Any:
        return await stream.StreamListener.bind(addr)

    def _now_ms(self) -> int:
        return _walltime.time_ns() // 1_000_000

    async def serve(self, addr: "str | tuple") -> None:
        from ..serve import AsyncWireServer, ChannelAdapter

        adapter = ChannelAdapter(self._serve_conn, codec, name="s3-enum")
        self._core = AsyncWireServer(adapter)
        self.bound_addr = await self._core.start(addr)
        try:
            await self._core._stopped.wait()
        finally:
            self._core._teardown()

    def close(self) -> None:
        core = getattr(self, "_core", None)
        if core is not None:
            core.close()


class LegacyServer(SimServer):
    """The pre-core accept loop (one task per ``accept1``) — kept as an
    A/B baseline; deprecated for serving."""

    async def serve(self, addr: "str | tuple") -> None:
        await _SimServer.serve(self, addr)


Server = SimServer  # the natural real-mode name


class Client(_SimClient):
    """The fluent-builder client dialing real framed-TCP connections."""

    _connect = staticmethod(stream.connect)


__all__ = [
    "ByteStream",
    "Client",
    "CompletedMultipartUpload",
    "CompletedPart",
    "Delete",
    "LegacyServer",
    "ObjectIdentifier",
    "S3Error",
    "S3Service",
    "Server",
    "SimServer",
]
