"""The S3 client — fluent builders mirroring the AWS SDK surface
(madsim-aws-sdk-s3/src/operation/*.rs, client.rs:29-57).

Every operation is a builder (``client.put_object().bucket(..).key(..)
.body(..).send()``) whose ``send`` performs one request exchange with the
SimServer. Output objects expose the SDK's accessor methods.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..net.endpoint import connect1_ephemeral, exchange1
from .service import S3Error


# -- model types ------------------------------------------------------------


@dataclass
class ObjectIdentifier:
    _key: str

    @staticmethod
    def builder() -> "ObjectIdentifierBuilder":
        return ObjectIdentifierBuilder()

    def key(self) -> str:
        return self._key


class ObjectIdentifierBuilder:
    def __init__(self) -> None:
        self._key: Optional[str] = None

    def key(self, key: str) -> "ObjectIdentifierBuilder":
        self._key = key
        return self

    def build(self) -> ObjectIdentifier:
        assert self._key is not None
        return ObjectIdentifier(self._key)


@dataclass
class Delete:
    _objects: List[ObjectIdentifier] = field(default_factory=list)

    @staticmethod
    def builder() -> "DeleteBuilder":
        return DeleteBuilder()

    def objects(self) -> List[ObjectIdentifier]:
        return self._objects


class DeleteBuilder:
    def __init__(self) -> None:
        self._objects: List[ObjectIdentifier] = []

    def objects(self, obj: ObjectIdentifier) -> "DeleteBuilder":
        self._objects.append(obj)
        return self

    def build(self) -> Delete:
        return Delete(self._objects)


@dataclass
class CompletedPart:
    _part_number: int
    _e_tag: Optional[str] = None

    @staticmethod
    def builder() -> "CompletedPartBuilder":
        return CompletedPartBuilder()

    def part_number(self) -> int:
        return self._part_number


class CompletedPartBuilder:
    def __init__(self) -> None:
        self._part_number: Optional[int] = None
        self._e_tag: Optional[str] = None

    def part_number(self, n: int) -> "CompletedPartBuilder":
        self._part_number = n
        return self

    def e_tag(self, tag: str) -> "CompletedPartBuilder":
        self._e_tag = tag
        return self

    def build(self) -> CompletedPart:
        assert self._part_number is not None
        return CompletedPart(self._part_number, self._e_tag)


@dataclass
class CompletedMultipartUpload:
    _parts: List[CompletedPart] = field(default_factory=list)

    @staticmethod
    def builder() -> "CompletedMultipartUploadBuilder":
        return CompletedMultipartUploadBuilder()

    def parts(self) -> List[CompletedPart]:
        return self._parts


class CompletedMultipartUploadBuilder:
    def __init__(self) -> None:
        self._parts: List[CompletedPart] = []

    def parts(self, part: CompletedPart) -> "CompletedMultipartUploadBuilder":
        self._parts.append(part)
        return self

    def build(self) -> CompletedMultipartUpload:
        return CompletedMultipartUpload(self._parts)


class ByteStream:
    """The SDK body type: ``await out.body.collect()`` → bytes."""

    def __init__(self, data: bytes):
        self._data = data

    async def collect(self) -> "ByteStream":
        return self

    def into_bytes(self) -> bytes:
        return self._data

    def to_bytes(self) -> bytes:
        return self._data

    @staticmethod
    def from_static(data: bytes) -> "ByteStream":
        return ByteStream(data)


# -- outputs ----------------------------------------------------------------


class _Output:
    def __init__(self, **kw: Any):
        self._kw = kw

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self._kw:
            value = self._kw[name]
            return lambda: value
        raise AttributeError(name)


@dataclass
class S3ListedObject:
    _key: str
    _size: int
    _e_tag: str

    def key(self) -> str:
        return self._key

    def size(self) -> int:
        return self._size

    def e_tag(self) -> str:
        return self._e_tag


# -- the client -------------------------------------------------------------


class _OpBuilder:
    """Generic fluent builder: setter per field, ``send`` runs the op."""

    _FIELDS: tuple = ()

    def __init__(self, client: "Client"):
        self._client = client
        self._args: Dict[str, Any] = {}

    def __getattr__(self, name: str):
        if name in type(self)._FIELDS:
            def setter(value: Any):
                self._args[name] = value
                return self

            return setter
        raise AttributeError(name)

    async def _call(self, req: tuple) -> Any:
        return await self._client._call(req)


def _op(name: str, fields: tuple, send):
    """Define one operation builder class."""
    cls = type(name, (_OpBuilder,), {"_FIELDS": fields, "send": send})
    return cls


async def _send_create_bucket(self):
    await self._call(("create_bucket", self._args["bucket"]))
    return _Output(bucket=self._args["bucket"])


async def _send_delete_bucket(self):
    await self._call(("delete_bucket", self._args["bucket"]))
    return _Output()


async def _send_list_buckets(self):
    names = await self._call(("list_buckets",))
    return _Output(buckets=[_Output(name=n) for n in names])


async def _send_put_object(self):
    body = self._args.get("body", b"")
    if isinstance(body, ByteStream):
        body = body.into_bytes()
    etag = await self._call(
        ("put_object", self._args["bucket"], self._args["key"], bytes(body))
    )
    return _Output(e_tag=etag)


async def _send_get_object(self):
    body, etag, modified = await self._call(
        ("get_object", self._args["bucket"], self._args["key"])
    )
    out = _Output(e_tag=etag, last_modified=modified, content_length=len(body))
    out.body = ByteStream(body)
    return out


async def _send_head_object(self):
    length, etag, modified = await self._call(
        ("head_object", self._args["bucket"], self._args["key"])
    )
    return _Output(content_length=length, e_tag=etag, last_modified=modified)


async def _send_delete_object(self):
    await self._call(("delete_object", self._args["bucket"], self._args["key"]))
    return _Output()


async def _send_delete_objects(self):
    delete: Delete = self._args["delete"]
    keys = [o.key() for o in delete.objects()]
    deleted = await self._call(("delete_objects", self._args["bucket"], keys))
    return _Output(deleted=[_Output(key=k) for k in deleted])


async def _send_list_objects_v2(self):
    contents, next_token, truncated = await self._call(
        (
            "list_objects_v2",
            self._args["bucket"],
            self._args.get("prefix", ""),
            self._args.get("continuation_token"),
            self._args.get("max_keys", 1000),
        )
    )
    return _Output(
        contents=[S3ListedObject(k, size, etag) for k, size, etag in contents],
        next_continuation_token=next_token,
        is_truncated=truncated,
        key_count=len(contents),
    )


async def _send_create_multipart_upload(self):
    upload_id = await self._call(
        ("create_multipart_upload", self._args["bucket"], self._args["key"])
    )
    return _Output(upload_id=upload_id)


async def _send_upload_part(self):
    body = self._args.get("body", b"")
    if isinstance(body, ByteStream):
        body = body.into_bytes()
    etag = await self._call(
        (
            "upload_part",
            self._args["bucket"],
            self._args["upload_id"],
            self._args["part_number"],
            bytes(body),
        )
    )
    return _Output(e_tag=etag)


async def _send_complete_multipart_upload(self):
    mp: CompletedMultipartUpload = self._args["multipart_upload"]
    part_numbers = [p.part_number() for p in mp.parts()]
    etag = await self._call(
        (
            "complete_multipart_upload",
            self._args["bucket"],
            self._args["upload_id"],
            part_numbers,
        )
    )
    return _Output(e_tag=etag, key=self._args.get("key"))


async def _send_abort_multipart_upload(self):
    await self._call(
        ("abort_multipart_upload", self._args["bucket"], self._args["upload_id"])
    )
    return _Output()


async def _send_put_lifecycle(self):
    await self._call(
        (
            "put_bucket_lifecycle_configuration",
            self._args["bucket"],
            self._args["lifecycle_configuration"],
        )
    )
    return _Output()


async def _send_get_lifecycle(self):
    config = await self._call(
        ("get_bucket_lifecycle_configuration", self._args["bucket"])
    )
    return _Output(rules=config)


_OPS = {
    "create_bucket": _op("CreateBucket", ("bucket",), _send_create_bucket),
    "delete_bucket": _op("DeleteBucket", ("bucket",), _send_delete_bucket),
    "list_buckets": _op("ListBuckets", (), _send_list_buckets),
    "put_object": _op("PutObject", ("bucket", "key", "body"), _send_put_object),
    "get_object": _op("GetObject", ("bucket", "key"), _send_get_object),
    "head_object": _op("HeadObject", ("bucket", "key"), _send_head_object),
    "delete_object": _op("DeleteObject", ("bucket", "key"), _send_delete_object),
    "delete_objects": _op("DeleteObjects", ("bucket", "delete"), _send_delete_objects),
    "list_objects_v2": _op(
        "ListObjectsV2",
        ("bucket", "prefix", "continuation_token", "max_keys"),
        _send_list_objects_v2,
    ),
    "create_multipart_upload": _op(
        "CreateMultipartUpload", ("bucket", "key"), _send_create_multipart_upload
    ),
    "upload_part": _op(
        "UploadPart",
        ("bucket", "key", "upload_id", "part_number", "body"),
        _send_upload_part,
    ),
    "complete_multipart_upload": _op(
        "CompleteMultipartUpload",
        ("bucket", "key", "upload_id", "multipart_upload"),
        _send_complete_multipart_upload,
    ),
    "abort_multipart_upload": _op(
        "AbortMultipartUpload",
        ("bucket", "key", "upload_id"),
        _send_abort_multipart_upload,
    ),
    "put_bucket_lifecycle_configuration": _op(
        "PutBucketLifecycleConfiguration",
        ("bucket", "lifecycle_configuration"),
        _send_put_lifecycle,
    ),
    "get_bucket_lifecycle_configuration": _op(
        "GetBucketLifecycleConfiguration", ("bucket",), _send_get_lifecycle
    ),
}


class Client:
    """``Client::send_request`` = one connect1 exchange per op
    (client.rs:29-57)."""

    def __init__(self, addr: str):
        self._addr = addr

    @classmethod
    def from_addr(cls, addr: str) -> "Client":
        return cls(addr)

    @classmethod
    def from_conf(cls, conf: Dict[str, Any]) -> "Client":
        return cls(conf["endpoint"])

    # transport hook — real/s3.py dials framed TCP instead
    _connect = staticmethod(connect1_ephemeral)

    async def _call(self, req: tuple) -> Any:
        try:
            tx, rx = await self._connect(self._addr)
            rsp = await exchange1(tx, rx, req)
        except (ConnectionError, OSError) as e:
            raise S3Error("TransportError", str(e)) from None
        if rsp is None:
            raise S3Error("TransportError", "connection closed")
        kind, payload = rsp
        if kind == "err":
            code, message = payload
            raise S3Error(code, message)
        return payload

    def __getattr__(self, name: str):
        op = _OPS.get(name)
        if op is None:
            raise AttributeError(name)
        return lambda: op(self)
