"""IP Virtual Server — simulated L4 load balancer
(ref madsim/src/sim/net/ipvs.rs:10-106).

Virtual services are keyed by ``ServiceAddr`` (protocol + "host:port"
string); each maps to a server list with a round-robin scheduler.  NetSim's
send/connect paths consult :meth:`get_server` to rewrite the destination
(ref net/mod.rs:312-317,345-350).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass(frozen=True)
class ServiceAddr:
    proto: str  # "tcp" | "udp"
    addr: str  # "host:port"

    @staticmethod
    def tcp(addr: str) -> "ServiceAddr":
        return ServiceAddr("tcp", addr)

    @staticmethod
    def udp(addr: str) -> "ServiceAddr":
        return ServiceAddr("udp", addr)


class _Service:
    def __init__(self, scheduler: str):
        self.scheduler = scheduler
        self.servers: List[str] = []
        self.rr_index = 0


class IpVirtualServer:
    def __init__(self) -> None:
        self._services: Dict[ServiceAddr, _Service] = {}

    def add_service(self, svc: ServiceAddr, scheduler: str = "rr") -> None:
        if scheduler not in ("rr",):
            raise ValueError(f"unknown scheduler: {scheduler}")
        self._services.setdefault(svc, _Service(scheduler))

    def del_service(self, svc: ServiceAddr) -> None:
        self._services.pop(svc, None)

    def add_server(self, svc: ServiceAddr, server: str) -> None:
        s = self._services.get(svc)
        if s is None:
            raise KeyError(f"no such service: {svc}")
        if server not in s.servers:
            s.servers.append(server)

    def del_server(self, svc: ServiceAddr, server: str) -> None:
        s = self._services.get(svc)
        if s is not None and server in s.servers:
            s.servers.remove(server)

    def get_server(self, svc: ServiceAddr) -> Optional[str]:
        """Round-robin pick (ref ipvs.rs RoundRobin scheduler)."""
        s = self._services.get(svc)
        if s is None or not s.servers:
            return None
        server = s.servers[s.rr_index % len(s.servers)]
        s.rr_index += 1
        return server

    def has_service(self, svc: ServiceAddr) -> bool:
        return svc in self._services
