"""Pure link-state network model (ref madsim/src/sim/net/network.rs:20-314).

Owns: node↔IP maps (one IP per node, network.rs:149-160), the socket table
keyed ``(node, ip, port, proto)``, clogged node in/out sets + clogged link
set (network.rs:27-29,162-203), loss/latency draws (``test_link``,
network.rs:261-269), destination resolution incl. 0.0.0.0 wildcard and
loopback (network.rs:272-313), and ephemeral port allocation
(network.rs:226-235).

No timers here: the model only *decides* (drop? latency?); scheduling the
delivery is NetSim's job, which is exactly the split that lets the TPU
engine lift this table as struct-of-arrays state (SURVEY.md §7).
"""

from __future__ import annotations

from typing import Dict, Optional, Protocol, Set, Tuple

from ..config import Config
from ..rand import GlobalRng
from ..task import NodeId

Addr = Tuple[str, int]  # (ip, port)

UDP = "udp"
TCP = "tcp"


def format_addr(addr: Addr) -> str:
    return f"{addr[0]}:{addr[1]}"


def parse_addr(addr: "str | Addr") -> Addr:
    if isinstance(addr, tuple):
        return (str(addr[0]), int(addr[1]))
    host, _, port = addr.rpartition(":")
    return (host, int(port))


def is_loopback(ip: str) -> bool:
    return ip.startswith("127.") or ip == "localhost" or ip == "::1"


class Socket(Protocol):
    """ref ``Socket`` trait (network.rs:50-60)."""

    def deliver(self, src: Addr, dst: Addr, msg: object) -> None: ...


class Stat:
    """ref ``Stat`` (network.rs:99-105)."""

    def __init__(self) -> None:
        self.msg_count = 0


class Network:
    def __init__(self, rng: GlobalRng, config: Config, now_ns=None):
        self.rng = rng
        self.config = config
        self.stat = Stat()
        self.node_ip: Dict[NodeId, str] = {}
        self.ip_node: Dict[str, NodeId] = {}
        # socket table: per-node {(ip, port, proto): Socket}
        self.sockets: Dict[NodeId, Dict[Tuple[str, int, str], Socket]] = {}
        self.clogged_node_in: Set[NodeId] = set()
        self.clogged_node_out: Set[NodeId] = set()
        self.clogged_links: Set[Tuple[NodeId, NodeId]] = set()
        self._next_ephemeral: Dict[NodeId, int] = {}

    # -- topology ----------------------------------------------------------

    def insert_node(self, id: NodeId) -> None:
        self.sockets.setdefault(id, {})
        if id not in self.node_ip:
            # auto-assign a unique IP; NodeBuilder.ip() overrides.  Skip
            # addresses the user already claimed.
            n = int(id)
            while True:
                ip = f"10.{200 + (n >> 16)}.{(n >> 8) & 0xFF}.{n & 0xFF}"
                if ip not in self.ip_node:
                    break
                n += 1
            self.set_ip(id, ip)

    def set_ip(self, id: NodeId, ip: str) -> None:
        old = self.node_ip.get(id)
        if old is not None and self.ip_node.get(old) == id:
            del self.ip_node[old]
        if ip in self.ip_node and self.ip_node[ip] != id:
            raise ValueError(f"IP {ip} is already assigned to node {self.ip_node[ip]}")
        self.node_ip[id] = ip
        self.ip_node[ip] = id

    def get_ip(self, id: NodeId) -> Optional[str]:
        return self.node_ip.get(id)

    def reset_node(self, id: NodeId) -> None:
        """Close all sockets on the node (ref network.rs:142-147)."""
        self.sockets[id] = {}

    # -- fault injection (network.rs:162-203) ------------------------------

    def clog_node_in(self, id: NodeId) -> None:
        self.clogged_node_in.add(id)

    def clog_node_out(self, id: NodeId) -> None:
        self.clogged_node_out.add(id)

    def unclog_node_in(self, id: NodeId) -> None:
        self.clogged_node_in.discard(id)

    def unclog_node_out(self, id: NodeId) -> None:
        self.clogged_node_out.discard(id)

    def clog_link(self, src: NodeId, dst: NodeId) -> None:
        self.clogged_links.add((src, dst))

    def unclog_link(self, src: NodeId, dst: NodeId) -> None:
        self.clogged_links.discard((src, dst))

    def is_clogged(self, src: NodeId, dst: NodeId) -> bool:
        return (
            src in self.clogged_node_out
            or dst in self.clogged_node_in
            or (src, dst) in self.clogged_links
        )

    def test_link(self, src: NodeId, dst: NodeId) -> Optional[float]:
        """None if clogged or lost, else a latency draw in seconds
        (ref network.rs:261-269)."""
        if self.is_clogged(src, dst):
            return None
        if self.rng.random() < self.config.net.packet_loss_rate:
            return None
        lo, hi = self.config.net.send_latency
        return self.rng.uniform(lo, hi)

    def latency(self) -> float:
        lo, hi = self.config.net.send_latency
        return self.rng.uniform(lo, hi)

    # -- sockets -----------------------------------------------------------

    def bind(
        self, node: NodeId, addr: Addr, proto: str, socket: Socket
    ) -> Addr:
        """Bind a socket; port 0 allocates an ephemeral port
        (ref network.rs:226-235)."""
        table = self.sockets.setdefault(node, {})
        ip, port = addr
        if port == 0:
            port = self._alloc_port(node, ip, proto)
        key = (ip, port, proto)
        if key in table:
            raise OSError(f"address already in use: {ip}:{port}/{proto}")
        table[key] = socket
        return (ip, port)

    def _alloc_port(self, node: NodeId, ip: str, proto: str) -> int:
        table = self.sockets.get(node, {})
        port = self._next_ephemeral.get(node, 32768)
        for _ in range(65536):
            if port > 65535:
                port = 32768
            if (ip, port, proto) not in table:
                self._next_ephemeral[node] = port + 1
                return port
            port += 1
        raise OSError("out of ephemeral ports")

    def close_socket(self, node: NodeId, addr: Addr, proto: str) -> None:
        table = self.sockets.get(node)
        if table is not None:
            table.pop((addr[0], addr[1], proto), None)

    def resolve_dest_node(self, src: NodeId, dst_ip: str) -> Optional[NodeId]:
        """ref network.rs:272-290 — loopback resolves to the sender node."""
        if is_loopback(dst_ip):
            return src
        if dst_ip == self.node_ip.get(src):
            return src
        return self.ip_node.get(dst_ip)

    def find_socket(
        self, node: NodeId, dst: Addr, proto: str
    ) -> Optional[Socket]:
        """Exact match, else 0.0.0.0 wildcard (ref network.rs:296-313)."""
        table = self.sockets.get(node)
        if table is None:
            return None
        sock = table.get((dst[0], dst[1], proto))
        if sock is None:
            sock = table.get(("0.0.0.0", dst[1], proto))
        return sock

    def try_send(
        self, src: NodeId, dst: Addr, proto: str
    ) -> Optional[Tuple[NodeId, Socket, float]]:
        """Resolve destination + link test; returns (dst_node, socket,
        latency_s) or None when dropped/unroutable (ref network.rs:296-313)."""
        dst_node = self.resolve_dest_node(src, dst[0])
        if dst_node is None:
            return None
        if dst_node == src:
            latency: Optional[float] = self.latency()  # loopback never drops
        else:
            latency = self.test_link(src, dst_node)
        if latency is None:
            return None
        socket = self.find_socket(dst_node, dst, proto)
        if socket is None:
            return None
        self.stat.msg_count += 1
        return (dst_node, socket, latency)
