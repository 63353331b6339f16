"""Simulated DNS (ref madsim/src/sim/net/dns.rs:1-38).

A global name→IP map with ``localhost`` pre-seeded; string host resolution
(``lookup_host``) goes through this, mirroring the reference's hook into
``ToSocketAddrs`` (net/addr.rs:255-257).
"""

from __future__ import annotations

from typing import Dict, Optional


class DnsServer:
    def __init__(self) -> None:
        self._records: Dict[str, str] = {"localhost": "127.0.0.1"}

    def add(self, name: str, ip: str) -> None:
        self._records[name] = ip

    def remove(self, name: str) -> None:
        self._records.pop(name, None)

    def lookup(self, name: str) -> Optional[str]:
        return self._records.get(name)
