"""S3 simulation — the madsim-aws-sdk-s3 analogue.

An in-memory S3 served over sim connections: the client sends one request
enum per ``connect1`` exchange (madsim-aws-sdk-s3/src/client.rs:29-57) to a
``SimServer`` dispatching the object/multipart/lifecycle operations
(server/rpc_server.rs:24-76) against per-bucket ordered maps
(``ServiceInner``). The client mirrors the AWS SDK's fluent-builder shape
(src/operation/*.rs):

    client = s3.Client.from_addr("10.0.0.1:9000")
    await client.put_object().bucket("b").key("k").body(b"...").send()
    out = await (await client.get_object().bucket("b").key("k").send()).body()
"""

from .client import (
    ByteStream,
    Client,
    CompletedMultipartUpload,
    CompletedPart,
    Delete,
    ObjectIdentifier,
)
from .server import SimServer
from .service import S3Error, S3Service

__all__ = [
    "ByteStream",
    "Client",
    "CompletedMultipartUpload",
    "CompletedPart",
    "Delete",
    "ObjectIdentifier",
    "S3Error",
    "S3Service",
    "SimServer",
]
