"""Simulated UDP socket — thin wrapper over Endpoint tag 0
(ref madsim/src/sim/net/udp.rs:10-73)."""

from __future__ import annotations

from typing import Tuple

from .endpoint import Endpoint
from .network import Addr

_UDP_TAG = 0


class UdpSocket:
    def __init__(self, ep: Endpoint):
        self._ep = ep

    @staticmethod
    async def bind(addr: "str | Addr") -> "UdpSocket":
        return UdpSocket(await Endpoint.bind(addr))

    async def connect(self, addr: "str | Addr") -> None:
        self._ep._peer = self._ep._netsim.resolve_host(addr)

    def local_addr(self) -> Addr:
        return self._ep.local_addr()

    def peer_addr(self) -> Addr:
        return self._ep.peer_addr()

    async def send_to(self, data: bytes, addr: "str | Addr") -> int:
        await self._ep.send_to(addr, _UDP_TAG, data)
        return len(data)

    async def recv_from(self) -> Tuple[bytes, Addr]:
        return await self._ep.recv_from(_UDP_TAG)

    async def send(self, data: bytes) -> int:
        return await self.send_to(data, self._ep.peer_addr())

    async def recv(self) -> bytes:
        data, _ = await self.recv_from()
        return data

    def close(self) -> None:
        self._ep.close()
