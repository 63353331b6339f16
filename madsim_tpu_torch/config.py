"""Simulation configuration (ref madsim/src/sim/config.rs:11-42).

TOML-parsable ``Config { net, tcp }`` with a stable content hash so test
failures can report the exact config that produced them.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field, asdict
from typing import Any, Dict, Tuple


@dataclass
class NetConfig:
    """ref sim/net/network.rs:66-97 — defaults: no loss, 1-10 ms latency."""

    packet_loss_rate: float = 0.0
    send_latency: Tuple[float, float] = (0.001, 0.010)  # seconds, [lo, hi)


@dataclass
class TcpConfig:
    """Placeholder, as in the reference (sim/net/tcp/config.rs:6-8)."""


@dataclass
class Config:
    net: NetConfig = field(default_factory=NetConfig)
    tcp: TcpConfig = field(default_factory=TcpConfig)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        net = d.get("net", {})
        latency = net.get("send_latency", (0.001, 0.010))
        if isinstance(latency, dict):  # TOML range table {start, end}
            latency = (latency["start"], latency["end"])
        return Config(
            net=NetConfig(
                packet_loss_rate=float(net.get("packet_loss_rate", 0.0)),
                send_latency=(float(latency[0]), float(latency[1])),
            ),
            tcp=TcpConfig(),
        )

    @staticmethod
    def from_toml(text: str) -> "Config":
        import tomllib

        return Config.from_dict(tomllib.loads(text))

    def hash(self) -> int:
        """Stable 64-bit content hash (ref config.rs ahash-based hash)."""
        blob = json.dumps(asdict(self), sort_keys=True, default=str)
        return int.from_bytes(
            hashlib.sha256(blob.encode()).digest()[:8], "little"
        )
