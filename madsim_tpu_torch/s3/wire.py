"""S3 REST wire: the framework's S3 state machine served over the REAL
S3 protocol (path-style REST + XML), so any stock S3 HTTP client can
create buckets, put/get/head/delete objects, page ListObjectsV2, and run
the multipart-upload lifecycle against it.

The reference's madsim-aws-sdk-s3 compiles to the *real* AWS SDK outside
the sim — its std mode speaks actual S3 REST. No AWS SDK is installed in
this image to point at this server, but the protocol itself is held:
``tests/test_s3_wire.py`` drives every operation with a stock HTTP
client, asserting S3's status codes, headers (ETag, Content-Length), and
XML shapes (ListBucketResult, InitiateMultipartUploadResult, Error).

Transport: a minimal HTTP/1.1 server on asyncio streams (keep-alive,
Content-Length bodies) — no web framework, mirroring how the repo's
other wire tiers stay dependency-light. Auth/signature headers are
accepted and ignored (the sim trusts its caller, like the reference
sim). XML parsing uses the stdlib ElementTree; this server is a test
double, not an internet-facing endpoint.

Scope: listing is **ListObjectsV2 only** — ``GET /bucket`` without
``list-type=2`` (ListObjects v1, the default for several stock SDK code
paths) is rejected with ``InvalidArgument`` rather than served with
Marker/NextMarker pagination; configure clients for v2 listing. Ranged
reads are **not supported** either: ``GetObject`` ignores a ``Range``
header and always returns the full body with 200 (no 206/Content-Range).
Both are deliberate test-double boundaries, not oversights (README
"ecosystem shims" scope note).

Operation map (path-style):
  PUT    /bucket                         CreateBucket
  DELETE /bucket                         DeleteBucket
  GET    /                               ListBuckets
  GET    /bucket?list-type=2&...         ListObjectsV2
  POST   /bucket?delete                  DeleteObjects (XML body)
  PUT    /bucket/key                     PutObject
  GET    /bucket/key                     GetObject
  HEAD   /bucket/key                     HeadObject
  DELETE /bucket/key                     DeleteObject
  POST   /bucket/key?uploads             CreateMultipartUpload
  PUT    /bucket/key?partNumber&uploadId UploadPart
  POST   /bucket/key?uploadId            CompleteMultipartUpload (XML)
  DELETE /bucket/key?uploadId            AbortMultipartUpload
"""

from __future__ import annotations

import asyncio
import time as _walltime
import urllib.parse
import xml.etree.ElementTree as ET
from email.utils import formatdate
from typing import Dict, Optional, Tuple

from .service import S3Error, S3Service

_ERROR_STATUS = {
    "NoSuchBucket": 404,
    "NoSuchKey": 404,
    "NoSuchUpload": 404,
    "NoSuchLifecycleConfiguration": 404,
    "BucketAlreadyExists": 409,
    "BucketNotEmpty": 409,
    "InvalidPart": 400,
    "InvalidPartOrder": 400,
    "InvalidArgument": 400,
}


def _xml(tag: str, children: str) -> bytes:
    return (
        f'<?xml version="1.0" encoding="UTF-8"?>\n<{tag}>{children}</{tag}>'
    ).encode()


def _esc(s: str) -> str:
    return (
        s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
    )


def _local(tag: str) -> str:
    """Element local name: real S3 SDKs send namespaced bodies
    (xmlns="http://s3.amazonaws.com/doc/2006-03-01/"), so every lookup
    must match '{ns}Key' as well as bare 'Key'."""
    return tag.rsplit("}", 1)[-1]


def _elements(root: ET.Element, name: str):
    return [el for el in root.iter() if _local(el.tag) == name]


def _child_text(el: ET.Element, name: str, default: str = "") -> str:
    for child in el:
        if _local(child.tag) == name:
            return child.text or default
    return default


class _Request:
    def __init__(self, method: str, path: str, query: Dict[str, str],
                 headers: Dict[str, str], body: bytes):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body


class _Response:
    def __init__(self, status: int = 200, body: bytes = b"",
                 headers: Optional[Dict[str, str]] = None,
                 content_type: str = "application/xml"):
        self.status = status
        self.body = body
        self.headers = dict(headers or {})
        if body and "Content-Type" not in self.headers:
            self.headers["Content-Type"] = content_type


_REASON = {200: "OK", 204: "No Content", 400: "Bad Request",
           404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
           500: "Internal Server Error"}


class S3Rest:
    """The S3 REST engine: one parsed HTTP request in, one response out.

    Pure protocol meaning — no sockets, no buffering. Both servers (the
    shared-core :class:`WireServer` and the thread-per-connection
    :class:`LegacyWireServer`) dispatch through this one engine, which
    is what makes their response bytes identical by construction.
    ``clock_ms`` injects the timestamp source so the determinism leg can
    feed a seeded clock instead of wall time.
    """

    def __init__(self, service: Optional[S3Service] = None, telemetry=None,
                 clock_ms=None):
        self.service = service or S3Service()
        self.telemetry = telemetry
        self.clock_ms = clock_ms or (lambda: int(_walltime.time() * 1000))
        #: optional list of (request, clock_ms, (status, body, headers))
        #: — the live-vs-replay transcript, like ``KafkaWire.recorder``
        self.recorder = None
        self._now = 0

    def handle(self, req) -> Tuple[int, bytes, Dict[str, str]]:
        """Dispatch one request (any object with ``method``/``path``/
        ``query``/``headers``/``body``) → ``(status, body, headers)``.

        The clock is sampled exactly ONCE per request, up front — the
        same purity contract as ``KafkaWire.handle_frame``: the response
        is a pure function of (request, clock sample), which is what the
        recorded transcript replays against a fresh engine."""
        self._now = self.clock_ms()
        t0 = (_walltime.perf_counter()
              if self.telemetry is not None else 0.0)
        try:
            rsp = self._dispatch(req)
        except S3Error as e:
            rsp = _Response(
                _ERROR_STATUS.get(e.code, 400),
                _xml("Error",
                     f"<Code>{_esc(e.code)}</Code>"
                     f"<Message>{_esc(e.message)}</Message>"),
            )
        except Exception as e:  # noqa: BLE001 — wire boundary
            rsp = _Response(
                500,
                _xml("Error",
                     "<Code>InternalError</Code>"
                     f"<Message>{_esc(str(e))}</Message>"),
            )
        if self.telemetry is not None:
            self.telemetry.count(
                "s3_requests_total", help="requests served",
                method=req.method,
            )
            self.telemetry.observe(
                "s3_api_seconds",
                _walltime.perf_counter() - t0,
                help="per-request handling latency",
                method=req.method,
            )
        if self.recorder is not None:
            self.recorder.append(
                (req, self._now, (rsp.status, rsp.body, dict(rsp.headers)))
            )
        return rsp.status, rsp.body, rsp.headers

    # -- the S3 operation map -----------------------------------------------

    def _dispatch(self, req: _Request) -> _Response:
        bucket, _, key = req.path.lstrip("/").partition("/")
        if not bucket:
            if req.method == "GET":
                return self._list_buckets()
            raise S3Error("InvalidArgument", f"{req.method} on service root")
        if not key:
            return self._bucket_op(req, bucket)
        return self._object_op(req, bucket, key)

    def _list_buckets(self) -> _Response:
        names = "".join(
            f"<Bucket><Name>{_esc(n)}</Name></Bucket>"
            for n in self.service.list_buckets()
        )
        return _Response(
            200, _xml("ListAllMyBucketsResult", f"<Buckets>{names}</Buckets>")
        )

    def _bucket_op(self, req: _Request, bucket: str) -> _Response:
        svc = self.service
        if req.method == "PUT":
            svc.create_bucket(bucket)
            return _Response(200)
        if req.method == "HEAD":
            # HeadBucket: SDKs probe bucket existence with it
            svc.head_bucket(bucket)  # raises NoSuchBucket -> 404
            return _Response(200)
        if req.method == "DELETE":
            svc.delete_bucket(bucket)
            return _Response(204)
        if req.method == "GET" and req.query.get("list-type") == "2":
            contents, next_token, truncated = svc.list_objects_v2(
                bucket,
                req.query.get("prefix", ""),
                req.query.get("continuation-token") or None,
                int(req.query.get("max-keys", "1000")),
            )
            inner = "".join(
                f"<Contents><Key>{_esc(k)}</Key><Size>{size}</Size>"
                f"<ETag>{_esc(etag)}</ETag></Contents>"
                for k, size, etag in contents
            )
            inner += (
                f"<KeyCount>{len(contents)}</KeyCount>"
                f"<Prefix>{_esc(req.query.get('prefix', ''))}</Prefix>"
                f"<IsTruncated>{'true' if truncated else 'false'}</IsTruncated>"
            )
            if next_token:
                inner += (
                    "<NextContinuationToken>"
                    f"{_esc(next_token)}</NextContinuationToken>"
                )
            return _Response(200, _xml("ListBucketResult", inner))
        if req.method == "POST" and "delete" in req.query:
            root = ET.fromstring(req.body.decode())
            keys = [
                _child_text(el, "Key") for el in _elements(root, "Object")
            ]
            deleted = self.service.delete_objects(bucket, keys)
            inner = "".join(
                f"<Deleted><Key>{_esc(k)}</Key></Deleted>" for k in deleted
            )
            return _Response(200, _xml("DeleteResult", inner))
        raise S3Error("InvalidArgument", f"{req.method} /{bucket}")

    def _object_op(self, req: _Request, bucket: str, key: str) -> _Response:
        svc = self.service
        now_ms = self._now  # the one per-request clock sample (handle())
        if req.method == "PUT" and "uploadId" in req.query:
            if "x-amz-copy-source" in req.headers:
                # UploadPartCopy: the part body comes from an existing
                # object, answered with a CopyPartResult document
                src = urllib.parse.unquote(req.headers["x-amz-copy-source"])
                src_bucket, _, src_key = src.lstrip("/").partition("/")
                body = svc.get_object(src_bucket, src_key).body
            else:
                body = req.body
            etag = svc.upload_part(
                bucket,
                req.query["uploadId"],
                int(req.query.get("partNumber", "0")),
                body,
            )
            if "x-amz-copy-source" in req.headers:
                return _Response(
                    200,
                    _xml(
                        "CopyPartResult",
                        f"<ETag>{_esc(etag)}</ETag>"
                        f"<LastModified>"
                        f"{_esc(formatdate(now_ms / 1000, usegmt=True))}"
                        f"</LastModified>",
                    ),
                )
            return _Response(200, headers={"ETag": etag})
        if req.method == "PUT" and "x-amz-copy-source" in req.headers:
            # CopyObject: source is "/bucket/key" (optionally URL-encoded)
            src = urllib.parse.unquote(req.headers["x-amz-copy-source"])
            src_bucket, _, src_key = src.lstrip("/").partition("/")
            obj = svc.get_object(src_bucket, src_key)
            etag = svc.put_object(bucket, key, obj.body, now_ms)
            return _Response(
                200,
                _xml(
                    "CopyObjectResult",
                    f"<ETag>{_esc(etag)}</ETag>"
                    f"<LastModified>{_esc(formatdate(now_ms / 1000, usegmt=True))}"
                    f"</LastModified>",
                ),
            )
        if req.method == "PUT":
            etag = svc.put_object(bucket, key, req.body, now_ms)
            return _Response(200, headers={"ETag": etag})
        if req.method in ("GET", "HEAD"):
            obj = svc.get_object(bucket, key)
            return _Response(
                200,
                obj.body,
                headers={
                    "ETag": obj.e_tag,
                    "Last-Modified": formatdate(
                        obj.last_modified_ms / 1000, usegmt=True
                    ),
                },
                content_type="application/octet-stream",
            )
        if req.method == "DELETE" and "uploadId" in req.query:
            svc.abort_multipart_upload(bucket, req.query["uploadId"])
            return _Response(204)
        if req.method == "DELETE":
            svc.delete_object(bucket, key)
            return _Response(204)
        if req.method == "POST" and "uploads" in req.query:
            upload_id = svc.create_multipart_upload(bucket, key)
            return _Response(
                200,
                _xml(
                    "InitiateMultipartUploadResult",
                    f"<Bucket>{_esc(bucket)}</Bucket><Key>{_esc(key)}</Key>"
                    f"<UploadId>{_esc(upload_id)}</UploadId>",
                ),
            )
        if req.method == "POST" and "uploadId" in req.query:
            root = ET.fromstring(req.body.decode())
            part_numbers = [
                int(_child_text(el, "PartNumber", "0"))
                for el in _elements(root, "Part")
            ]
            etag = svc.complete_multipart_upload(
                bucket, req.query["uploadId"], part_numbers, now_ms
            )
            return _Response(
                200,
                _xml(
                    "CompleteMultipartUploadResult",
                    f"<Bucket>{_esc(bucket)}</Bucket><Key>{_esc(key)}</Key>"
                    f"<ETag>{_esc(etag)}</ETag>",
                ),
            )
        raise S3Error("InvalidArgument", f"{req.method} /{bucket}/{key}")


class WireServer:
    """Serve an :class:`S3Service` over S3 REST on a real TCP port,
    multiplexed by the shared serving core (``madsim_tpu_torch/serve/``):
    incremental HTTP parsing, bounded write queues, slow-client
    eviction, and ``serve_*`` metrics come from the core; this class
    owns only the S3 meaning via :class:`S3Rest`."""

    def __init__(self, service: Optional[S3Service] = None, telemetry=None,
                 clock_ms=None, shards: int = 1):
        self.rest = S3Rest(service, telemetry=telemetry, clock_ms=clock_ms)
        self.service = self.rest.service
        self.telemetry = telemetry
        self.bound_addr: Optional[Tuple[str, int]] = None
        self._shards = shards
        self._core = None
        self.adapter = None  # set at start; carries the stall hook

    def _count_conn(self, _conn) -> None:
        if self.telemetry is not None:
            self.telemetry.count(
                "s3_connections_total", help="accepted connections"
            )

    async def start(self, addr: "str | tuple") -> None:
        from ..serve import AsyncWireServer, HttpAdapter

        self.adapter = HttpAdapter(
            self.rest.handle, name="s3", connect_hook=self._count_conn
        )
        self._core = AsyncWireServer(
            self.adapter, telemetry=self.telemetry, shards=self._shards
        )
        self.bound_addr = await self._core.start(addr)

    async def serve(self, addr: "str | tuple") -> None:
        await self.start(addr)
        try:
            await self._core._stopped.wait()
        finally:
            self._core._teardown()

    def close(self) -> None:
        if self._core is not None:
            self._core.close()

    async def aclose(self, drain_timeout: float = 5.0) -> None:
        if self._core is not None:
            await self._core.aclose(drain_timeout)


class LegacyWireServer:
    """The pre-core transport: one asyncio-streams task per connection,
    unbounded write buffering. Kept as the A/B baseline for parity and
    determinism gates; deprecated for serving — see docs/wire.md.
    Dispatch goes through the same :class:`S3Rest` engine, so response
    bytes match the core-backed server exactly."""

    def __init__(self, service: Optional[S3Service] = None, telemetry=None,
                 clock_ms=None):
        self.rest = S3Rest(service, telemetry=telemetry, clock_ms=clock_ms)
        self.service = self.rest.service
        self.telemetry = telemetry
        self.bound_addr: Optional[Tuple[str, int]] = None
        self._server: Optional[asyncio.AbstractServer] = None

    async def serve(self, addr: "str | tuple") -> None:
        host, port = addr if isinstance(addr, tuple) else addr.rsplit(":", 1)
        self._server = await asyncio.start_server(self._conn, host, int(port))
        self.bound_addr = self._server.sockets[0].getsockname()[:2]
        async with self._server:
            await self._server.serve_forever()

    def close(self) -> None:
        if self._server is not None:
            self._server.close()

    # -- HTTP/1.1 plumbing --------------------------------------------------

    async def _conn(self, reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter) -> None:
        if self.telemetry is not None:
            self.telemetry.count(
                "s3_connections_total", help="accepted connections"
            )
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    return
                status, body, headers = self.rest.handle(req)
                await self._write_response(
                    writer, req, _Response(status, body, headers)
                )
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    @staticmethod
    async def _read_request(reader: asyncio.StreamReader) -> Optional[_Request]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
        lines = head.decode("latin-1").split("\r\n")
        method, target, _version = lines[0].split(" ", 2)
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()
        parsed = urllib.parse.urlsplit(target)
        query = {
            k: v[0] if v else ""
            for k, v in urllib.parse.parse_qs(
                parsed.query, keep_blank_values=True
            ).items()
        }
        length = int(headers.get("content-length", "0"))
        body = await reader.readexactly(length) if length else b""
        return _Request(
            method, urllib.parse.unquote(parsed.path), query, headers, body
        )

    @staticmethod
    async def _write_response(writer: asyncio.StreamWriter, req: _Request,
                              rsp: _Response) -> None:
        head_only = req.method == "HEAD"
        body = b"" if head_only else rsp.body
        lines = [f"HTTP/1.1 {rsp.status} {_REASON.get(rsp.status, 'OK')}"]
        headers = dict(rsp.headers)
        # HEAD advertises the real entity length; the others, the sent one
        headers["Content-Length"] = str(len(rsp.body))
        headers.setdefault("Server", "madsim-s3-wire")
        for k, v in headers.items():
            lines.append(f"{k}: {v}")
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode() + body)
        await writer.drain()
