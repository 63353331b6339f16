"""The S3 sim server node (madsim-aws-sdk-s3/src/server/rpc_server.rs).

One request tuple per ``connect1`` exchange, dispatched over the service
operations (rpc_server.rs:24-76).
"""

from __future__ import annotations

from typing import Any

from .. import task as mstask
from ..context import current_handle
from ..net.endpoint import Endpoint as NetEndpoint
from .service import S3Error, S3Service


class SimServer:
    # executor/clock bindings as class attributes so the real-mode twin
    # (real/s3.py) rebinds them to asyncio + the wall clock while reusing
    # the dispatcher (the sim/std split of madsim-aws-sdk-s3/src/lib.rs)
    _spawn = staticmethod(mstask.spawn)

    @staticmethod
    async def _bind(addr: "str | tuple") -> Any:
        return await NetEndpoint.bind(addr)

    def __init__(self, service: "S3Service | None" = None) -> None:
        self.service = service or S3Service()
        #: set once the listener is bound (port-0 discovery, real mode)
        self.bound_addr: "tuple | None" = None

    async def serve(self, addr: "str | tuple") -> None:
        ep = await self._bind(addr)
        local = getattr(ep, "local_addr", None)
        self.bound_addr = local() if callable(local) else None
        while True:
            tx, rx, _src = await ep.accept1()
            self._spawn(self._serve_conn(tx, rx), name="s3-conn")

    async def _serve_conn(self, tx: Any, rx: Any) -> None:
        try:
            req = await rx.recv()
            if req is None:
                return
            try:
                await tx.send(("ok", self._handle(req)))
            except S3Error as e:
                await tx.send(("err", (e.code, e.message)))
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            tx.close()

    def _now_ms(self) -> int:
        return current_handle().time.now_time_ns() // 1_000_000

    def _handle(self, req: tuple) -> Any:
        s = self.service
        op, args = req[0], req[1:]
        if op == "create_bucket":
            return s.create_bucket(*args)
        if op == "delete_bucket":
            return s.delete_bucket(*args)
        if op == "list_buckets":
            return s.list_buckets()
        if op == "put_object":
            bucket, key, body = args
            return s.put_object(bucket, key, body, self._now_ms())
        if op == "get_object":
            obj = s.get_object(*args)
            return (obj.body, obj.e_tag, obj.last_modified_ms)
        if op == "head_object":
            return s.head_object(*args)
        if op == "delete_object":
            return s.delete_object(*args)
        if op == "delete_objects":
            return s.delete_objects(*args)
        if op == "list_objects_v2":
            return s.list_objects_v2(*args)
        if op == "create_multipart_upload":
            return s.create_multipart_upload(*args)
        if op == "upload_part":
            return s.upload_part(*args)
        if op == "complete_multipart_upload":
            bucket, upload_id, part_numbers = args
            return s.complete_multipart_upload(
                bucket, upload_id, part_numbers, self._now_ms()
            )
        if op == "abort_multipart_upload":
            return s.abort_multipart_upload(*args)
        if op == "put_bucket_lifecycle_configuration":
            return s.put_bucket_lifecycle_configuration(*args)
        if op == "get_bucket_lifecycle_configuration":
            return s.get_bucket_lifecycle_configuration(*args)
        raise S3Error("NotImplemented", f"unknown op {op!r}")
