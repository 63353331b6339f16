"""The S3 state machine (madsim-aws-sdk-s3/src/server/service.rs).

``ServiceInner`` — per-bucket ordered maps of objects plus in-progress
multipart uploads and bucket lifecycle configuration. Pure deterministic
state; the server node wraps it.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


class S3Error(Exception):
    """AWS-style coded error (NoSuchBucket / NoSuchKey / ...)."""

    def __init__(self, code: str, message: str):
        self.code = code
        self.message = message
        super().__init__(f"{code}: {message}")


def _etag(body: bytes) -> str:
    return '"' + hashlib.md5(body).hexdigest() + '"'


@dataclass
class S3Object:
    body: bytes
    e_tag: str
    last_modified_ms: int


@dataclass
class MultipartUpload:
    key: str
    parts: Dict[int, bytes] = field(default_factory=dict)


@dataclass
class Bucket:
    objects: Dict[str, S3Object] = field(default_factory=dict)
    uploads: Dict[str, MultipartUpload] = field(default_factory=dict)
    lifecycle: Optional[Any] = None
    next_upload: int = 1


class S3Service:
    def __init__(self) -> None:
        self.buckets: Dict[str, Bucket] = {}

    def _bucket(self, name: str) -> Bucket:
        b = self.buckets.get(name)
        if b is None:
            raise S3Error("NoSuchBucket", f"The specified bucket does not exist: {name}")
        return b

    # -- bucket lifecycle ---------------------------------------------------

    def create_bucket(self, name: str) -> None:
        if name in self.buckets:
            raise S3Error("BucketAlreadyExists", name)
        self.buckets[name] = Bucket()

    def delete_bucket(self, name: str) -> None:
        b = self._bucket(name)
        if b.objects:
            raise S3Error("BucketNotEmpty", name)
        del self.buckets[name]

    def list_buckets(self) -> List[str]:
        return sorted(self.buckets)

    def head_bucket(self, name: str) -> None:
        """Existence probe (S3 HeadBucket); raises NoSuchBucket."""
        self._bucket(name)

    # -- objects ------------------------------------------------------------

    def put_object(self, bucket: str, key: str, body: bytes, now_ms: int) -> str:
        b = self._bucket(bucket)
        obj = S3Object(body=body, e_tag=_etag(body), last_modified_ms=now_ms)
        b.objects[key] = obj
        return obj.e_tag

    def get_object(self, bucket: str, key: str) -> S3Object:
        b = self._bucket(bucket)
        obj = b.objects.get(key)
        if obj is None:
            raise S3Error("NoSuchKey", f"The specified key does not exist: {key}")
        return obj

    def head_object(self, bucket: str, key: str) -> Tuple[int, str, int]:
        obj = self.get_object(bucket, key)
        return len(obj.body), obj.e_tag, obj.last_modified_ms

    def delete_object(self, bucket: str, key: str) -> None:
        self._bucket(bucket).objects.pop(key, None)  # S3 delete is idempotent

    def delete_objects(self, bucket: str, keys: List[str]) -> List[str]:
        b = self._bucket(bucket)
        deleted = []
        for key in keys:
            b.objects.pop(key, None)
            deleted.append(key)
        return deleted

    def list_objects_v2(
        self,
        bucket: str,
        prefix: str,
        continuation_token: Optional[str],
        max_keys: int,
    ) -> Tuple[List[Tuple[str, int, str]], Optional[str], bool]:
        """Returns ([(key, size, etag)], next_token, is_truncated) in
        lexicographic key order (the BTreeMap semantics of the reference)."""
        b = self._bucket(bucket)
        if max_keys <= 0:
            return [], None, False
        keys = sorted(k for k in b.objects if k.startswith(prefix))
        if continuation_token:
            keys = [k for k in keys if k > continuation_token]
        page, rest = keys[:max_keys], keys[max_keys:]
        contents = [
            (k, len(b.objects[k].body), b.objects[k].e_tag) for k in page
        ]
        next_token = page[-1] if rest else None
        return contents, next_token, bool(rest)

    # -- multipart upload lifecycle -----------------------------------------

    def create_multipart_upload(self, bucket: str, key: str) -> str:
        b = self._bucket(bucket)
        upload_id = f"upload-{b.next_upload}"
        b.next_upload += 1
        b.uploads[upload_id] = MultipartUpload(key=key)
        return upload_id

    def _upload(self, bucket: str, upload_id: str) -> MultipartUpload:
        up = self._bucket(bucket).uploads.get(upload_id)
        if up is None:
            raise S3Error("NoSuchUpload", upload_id)
        return up

    def upload_part(
        self, bucket: str, upload_id: str, part_number: int, body: bytes
    ) -> str:
        if part_number < 1:
            raise S3Error("InvalidArgument", "part numbers start at 1")
        self._upload(bucket, upload_id).parts[part_number] = body
        return _etag(body)

    def complete_multipart_upload(
        self, bucket: str, upload_id: str, part_numbers: List[int], now_ms: int
    ) -> str:
        up = self._upload(bucket, upload_id)
        missing = [n for n in part_numbers if n not in up.parts]
        if missing:
            raise S3Error("InvalidPart", f"missing parts: {missing}")
        if part_numbers != sorted(part_numbers):
            raise S3Error(
                "InvalidPartOrder",
                "the list of parts was not in ascending order",
            )
        body = b"".join(up.parts[n] for n in part_numbers)
        etag = self.put_object(bucket, up.key, body, now_ms)
        del self._bucket(bucket).uploads[upload_id]
        return etag

    def abort_multipart_upload(self, bucket: str, upload_id: str) -> None:
        self._upload(bucket, upload_id)
        del self._bucket(bucket).uploads[upload_id]

    # -- bucket lifecycle configuration --------------------------------------

    def put_bucket_lifecycle_configuration(self, bucket: str, config: Any) -> None:
        self._bucket(bucket).lifecycle = config

    def get_bucket_lifecycle_configuration(self, bucket: str) -> Any:
        lc = self._bucket(bucket).lifecycle
        if lc is None:
            raise S3Error(
                "NoSuchLifecycleConfiguration", "the lifecycle configuration does not exist"
            )
        return lc
