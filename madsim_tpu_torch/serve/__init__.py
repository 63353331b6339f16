"""``madsim_tpu_torch.serve`` — the shared async wire-serving core.

One ``asyncio.Protocol``-based event loop (optionally SO_REUSEPORT loop
shards) multiplexes every real-TCP wire tier: framing/reassembly, per-
connection state, bounded-queue backpressure, slow-client eviction,
lifecycle metrics, and gray-failure read-stall injection live here once;
the Kafka/S3/etcd wires are thin adapters (``serve/adapters.py``). See
docs/wire.md ("Async serving core").
"""

from .core import AsyncWireServer, Conn, DropConnection, WireAdapter
from .framing import (
    FramingError,
    HttpRequest,
    HttpRequestFramer,
    LengthPrefixFramer,
    frame,
    render_http_response,
)
from .adapters import (
    ChannelAdapter,
    ChannelReceiver,
    ChannelSender,
    HttpAdapter,
    PureFrameAdapter,
)

__all__ = [
    "AsyncWireServer",
    "ChannelAdapter",
    "ChannelReceiver",
    "ChannelSender",
    "Conn",
    "DropConnection",
    "FramingError",
    "HttpAdapter",
    "HttpRequest",
    "HttpRequestFramer",
    "LengthPrefixFramer",
    "PureFrameAdapter",
    "WireAdapter",
    "frame",
    "render_http_response",
]
