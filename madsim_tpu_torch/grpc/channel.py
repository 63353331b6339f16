"""Client transport: Endpoint builder + load-balanced Channel.

Mirrors madsim-tonic ``transport::{Endpoint, Channel}``
(transport/channel.rs:113-359): the Endpoint builder honors ``timeout`` and
``connect_timeout`` and *accepts-and-ignores* the HTTP2/TCP tuning knobs
(they have no meaning on a simulated link); ``Channel`` picks a random
endpoint per call (``balance_list``) and supports a dynamic endpoint set
fed through a channel (``balance_channel`` — Change::Insert/Remove).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .. import rand as msrand
from .. import time as mstime
from ..net.endpoint import connect1_ephemeral
from .status import Status


class Endpoint:
    """Builder for one server address (tonic ``transport::Endpoint``).

    ``_channel_cls`` / ``_timeout`` / ``_timeout_error`` are overridden by
    the real-mode twin (real/grpc.py) to bind the same builder surface to
    asyncio + real sockets."""

    _channel_cls: "type | None" = None  # defaults to Channel below
    _timeout_fn = staticmethod(mstime.timeout)
    _timeout_error: type = mstime.TimeoutError

    def __init__(self, uri: str):
        self.uri = uri
        self._timeout: Optional[float] = None
        self._connect_timeout: Optional[float] = None

    @classmethod
    def from_static(cls, uri: str) -> "Endpoint":
        return cls(uri)

    @classmethod
    def from_shared(cls, uri: str) -> "Endpoint":
        return cls(uri)

    def timeout(self, seconds: float) -> "Endpoint":
        """Per-RPC timeout applied to every call on the channel
        (transport/channel.rs:129-135)."""
        self._timeout = seconds
        return self

    def connect_timeout(self, seconds: float) -> "Endpoint":
        self._connect_timeout = seconds
        return self

    # accepted-and-ignored knobs (transport/channel.rs:137-188): they tune
    # a real HTTP/2 stack the simulator doesn't have
    def _ignore(self, *_a: Any, **_k: Any) -> "Endpoint":
        return self

    concurrency_limit = _ignore
    rate_limit = _ignore
    initial_stream_window_size = _ignore
    initial_connection_window_size = _ignore
    tcp_keepalive = _ignore
    tcp_nodelay = _ignore
    http2_keep_alive_interval = _ignore
    keep_alive_timeout = _ignore
    keep_alive_while_idle = _ignore
    http2_adaptive_window = _ignore
    http2_max_header_list_size = _ignore
    buffer_size = _ignore
    executor = _ignore
    user_agent = _ignore
    origin = _ignore
    tls_config = _ignore

    def _addr(self) -> str:
        uri = self.uri
        for scheme in ("http://", "https://", "grpc://"):
            if uri.startswith(scheme):
                uri = uri[len(scheme):]
        return uri.rstrip("/")

    async def connect(self) -> "Channel":
        """Verify the server is reachable, then return a channel
        (connect_timeout honored; Unavailable on failure)."""
        ch = self.connect_lazy()
        try:
            if self._connect_timeout is not None:
                tx, rx = await self._timeout_fn(self._connect_timeout, ch._open(self._addr()))
            else:
                tx, rx = await ch._open(self._addr())
            tx.close()
            rx.close()
        except self._timeout_error:
            raise Status.unavailable(f"connect timed out: {self.uri}") from None
        except (ConnectionError, OSError) as e:
            raise Status.unavailable(f"transport error: {e}") from None
        return ch

    def connect_lazy(self) -> "Channel":
        return (self._channel_cls or Channel)([self])


class Change:
    """Endpoint-set mutation for ``balance_channel`` (tower discover)."""

    @staticmethod
    def insert(key: str, endpoint: "Endpoint") -> Tuple[str, str, "Endpoint"]:
        return ("insert", key, endpoint)

    @staticmethod
    def remove(key: str) -> Tuple[str, str, None]:
        return ("remove", key, None)


class Channel:
    """A (possibly load-balanced) virtual connection to servers.

    Per call: pick a random endpoint (the reference balances randomly —
    transport/channel.rs:294-307) and open a fresh sim connection.
    """

    def __init__(self, endpoints: List[Endpoint]):
        self._endpoints: Dict[str, Endpoint] = {
            str(i): ep for i, ep in enumerate(endpoints)
        }

    @classmethod
    def balance_list(cls, endpoints: List[Endpoint]) -> "Channel":
        return cls(list(endpoints))

    @classmethod
    def balance_channel(cls, capacity: int = 16) -> Tuple["Channel", "_BalanceSender"]:
        """Dynamic endpoint set: returns (channel, sender); feed the sender
        ``Change.insert/remove`` items (transport/channel.rs:335-359)."""
        ch = cls([])
        return ch, _BalanceSender(ch)

    @property
    def default_timeout(self) -> Optional[float]:
        for ep in self._endpoints.values():
            if ep._timeout is not None:
                return ep._timeout
        return None

    @staticmethod
    def _randint(n: int) -> int:
        """Balance draw — sim RNG here; real mode overrides with ``random``."""
        return msrand.gen_range(0, n)

    def _pick(self) -> Endpoint:
        if not self._endpoints:
            raise Status.unavailable("no endpoints available")
        keys = sorted(self._endpoints)
        key = keys[self._randint(len(keys))]
        return self._endpoints[key]

    async def _open(self, addr: str):
        """Open one sim connection (ephemeral source port, released on
        establishment)."""
        try:
            return await connect1_ephemeral(addr)
        except (ConnectionError, OSError) as e:
            raise Status.unavailable(f"transport error: {e}") from None

    async def open_stream(self):
        """(tx, rx) to a randomly balanced endpoint."""
        return await self._open(self._pick()._addr())


class _BalanceSender:
    """The sender half of ``balance_channel``."""

    def __init__(self, channel: Channel):
        self._channel = channel

    async def send(self, change: Tuple[str, str, Optional[Endpoint]]) -> None:
        op, key, ep = change
        if op == "insert" and ep is not None:
            self._channel._endpoints[key] = ep
        else:
            self._channel._endpoints.pop(key, None)
