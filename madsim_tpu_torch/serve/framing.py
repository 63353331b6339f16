"""Wire framing for the async serving core: incremental reassembly.

A framer owns one connection's read-side byte stream and turns arbitrary
chunk boundaries back into protocol units — the core calls ``feed`` with
whatever the transport delivered and dispatches each completed unit to
the wire adapter. Two framings cover every wire this repo serves:

- :class:`LengthPrefixFramer` — the repo-wide 4-byte big-endian length
  convention (``real/stream.py``), which is also exactly Kafka's binary
  framing, so the genuine Kafka wire and the framed-codec transports
  (etcd request enums, framed gRPC) share one parser;
- :class:`HttpRequestFramer` — a minimal incremental HTTP/1.1 request
  parser (request line + headers + Content-Length body, keep-alive),
  the S3 REST wire's transport.

Both are pure per-connection state machines: no I/O, no clocks — which
is what keeps the served responses a function of (request bytes, clock)
and the live-vs-replay byte-identity gate meaningful through the core.
"""

from __future__ import annotations

import struct
import urllib.parse
from typing import Dict, List, Optional

_LEN = struct.Struct(">I")

#: sanity ceiling shared with real/stream.py — not a protocol limit
MAX_FRAME = 64 * 1024 * 1024


class FramingError(Exception):
    """Bytes this framer refuses to parse — the connection is dropped
    hard, like a protocol violation on a real wire."""


class LengthPrefixFramer:
    """Reassemble 4-byte big-endian length-prefixed frames from
    arbitrary byte chunks (a pipe may deliver a frame whole; TCP may
    split it anywhere)."""

    __slots__ = ("_buf", "max_frame")

    def __init__(self, max_frame: int = MAX_FRAME):
        self._buf = bytearray()
        self.max_frame = max_frame

    def feed(self, chunk: bytes) -> List[bytes]:
        self._buf += chunk
        out: List[bytes] = []
        while len(self._buf) >= 4:
            (n,) = _LEN.unpack(self._buf[:4])
            if not 0 <= n <= self.max_frame:
                raise FramingError(f"insane frame length {n}")
            if len(self._buf) < 4 + n:
                break
            out.append(bytes(self._buf[4 : 4 + n]))
            del self._buf[: 4 + n]
        return out

    def pending(self) -> int:
        """Buffered bytes of an incomplete frame (tests/diagnostics)."""
        return len(self._buf)


def frame(body: bytes) -> bytes:
    """Length-prefix one frame body for the wire."""
    if len(body) > MAX_FRAME:
        raise FramingError(f"frame of {len(body)} bytes exceeds bound")
    return _LEN.pack(len(body)) + body


class HttpRequest:
    """One parsed HTTP/1.1 request — the unit the S3 adapter consumes.
    Field shape matches what ``s3/wire.py`` dispatches on."""

    __slots__ = ("method", "path", "query", "headers", "body")

    def __init__(self, method: str, path: str, query: Dict[str, str],
                 headers: Dict[str, str], body: bytes):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body


_MAX_HEAD = 64 * 1024  # request line + headers sanity bound


class HttpRequestFramer:
    """Incremental HTTP/1.1 request parser: head (request line +
    headers, terminated ``\\r\\n\\r\\n``) then a Content-Length body.
    Keep-alive: yields every complete request in the stream. No chunked
    transfer encoding (stock S3 SDK PUTs carry Content-Length)."""

    __slots__ = ("_buf", "_head", "_need", "max_body")

    def __init__(self, max_body: int = MAX_FRAME):
        self._buf = bytearray()
        self._head: Optional[HttpRequest] = None  # parsed, awaiting body
        self._need = 0  # body bytes still missing
        self.max_body = max_body

    def feed(self, chunk: bytes) -> List[HttpRequest]:
        self._buf += chunk
        out: List[HttpRequest] = []
        while True:
            if self._head is None:
                end = self._buf.find(b"\r\n\r\n")
                if end < 0:
                    if len(self._buf) > _MAX_HEAD:
                        raise FramingError("oversized request head")
                    break
                self._head, self._need = self._parse_head(
                    bytes(self._buf[: end + 4])
                )
                del self._buf[: end + 4]
            if len(self._buf) < self._need:
                break
            req = self._head
            req.body = bytes(self._buf[: self._need])
            del self._buf[: self._need]
            self._head, self._need = None, 0
            out.append(req)
        return out

    def _parse_head(self, head: bytes):
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _version = lines[0].split(" ", 2)
        except ValueError:
            raise FramingError(f"bad request line {lines[0]!r}") from None
        headers: Dict[str, str] = {}
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
        try:
            need = int(headers.get("content-length", "0"))
        except ValueError:
            raise FramingError("unparseable Content-Length") from None
        if not 0 <= need <= self.max_body:
            raise FramingError(f"insane Content-Length {need}")
        req = HttpRequest(
            method, urllib.parse.unquote(parsed.path), query, headers, b""
        )
        return req, need

    def pending(self) -> int:
        return len(self._buf)


_REASON = {200: "OK", 204: "No Content", 400: "Bad Request",
           404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
           500: "Internal Server Error", 503: "Service Unavailable"}


def render_http_response(status: int, body: bytes,
                         headers: Dict[str, str],
                         head_only: bool = False) -> bytes:
    """Render one HTTP/1.1 response. ``head_only`` (a HEAD request)
    advertises the real entity length but sends no body."""
    sent = b"" if head_only else body
    lines = [f"HTTP/1.1 {status} {_REASON.get(status, 'OK')}"]
    hdrs = dict(headers)
    hdrs["Content-Length"] = str(len(body))
    hdrs.setdefault("Server", "madsim-s3-wire")
    for k, v in hdrs.items():
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode() + sent
