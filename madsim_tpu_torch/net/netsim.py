"""NetSim plugin: fault-injection API + message scheduling + reliable
connection channels (ref madsim/src/sim/net/mod.rs:82-494).

Per-message path (ref net/mod.rs:287-333): random processing delay 0-5 µs
(buggified to 1-5 s at 10%), RPC drop hooks, IPVS destination rewrite, then
``Network.try_send`` decides drop/latency and the delivery is scheduled as a
virtual-time timer — the node boundary is crossed *only* via timers, which
is the invariant the TPU engine batches.

``connect1`` (ref net/mod.rs:337-405) creates a reliable duplex channel pair
whose receiver re-tests the link per message with exponential backoff
1 ms → 10 s while clogged — TCP-like semantics (no loss, blocked by
partitions, broken by node kill).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ..config import Config
from ..futures import Future
from ..plugin import Simulator
from ..rand import GlobalRng
from ..task import NodeId
from ..time import Sleep, TimeHandle, _new_sleep
from .dns import DnsServer
from .ipvs import IpVirtualServer, ServiceAddr
from .network import TCP, UDP, Addr, Network, Socket, Stat, parse_addr

Hook = Callable[[NodeId, Addr, int, Any], bool]  # -> True = drop


class NetSim(Simulator):
    """The network simulator plugin (ref ``NetSim``, net/mod.rs:82-161)."""

    def __init__(self, rng: GlobalRng, time: TimeHandle, config: Config):
        super().__init__(rng, time, config)
        self.network = Network(rng, config)
        self.dns = DnsServer()
        self.ipvs = IpVirtualServer()
        self._rpc_req_hooks: List[Hook] = []
        self._rpc_rsp_hooks: List[Hook] = []
        self._node_pipes: Dict[NodeId, List["_Pipe"]] = {}
        # per-node Unix-domain namespaces (net/unix.py): (node, path) ->
        # listener accept queue / datagram socket. Paths are node-local
        # like the per-node fs, so entries die with the node.
        self.unix_listeners: Dict[Tuple[NodeId, str], Any] = {}
        self.unix_dgrams: Dict[Tuple[NodeId, str], Any] = {}

    # -- plugin lifecycle --------------------------------------------------

    def create_node(self, id: NodeId) -> None:
        self.network.insert_node(id)
        self._node_pipes.setdefault(id, [])

    def reset_node(self, id: NodeId) -> None:
        """Close sockets and break live connections
        (ref net/mod.rs:146-149)."""
        self.network.reset_node(id)
        pipes = self._node_pipes.get(id, [])
        self._node_pipes[id] = []
        for pipe in pipes:
            pipe.break_pipe()
        # unix namespaces are node-local state: drop them with the node
        for key in [k for k in self.unix_listeners if k[0] == id]:
            self.unix_listeners.pop(key).break_all()
        for key in [k for k in self.unix_dgrams if k[0] == id]:
            self.unix_dgrams.pop(key)._broken = True

    # -- config / topology -------------------------------------------------

    def update_config(self, config: Config) -> None:
        """ref net/mod.rs:137-141."""
        self.config = config
        self.network.config = config

    def set_ip(self, id: NodeId, ip: str) -> None:
        self.network.set_ip(id, ip)

    def get_ip(self, id: NodeId) -> Optional[str]:
        return self.network.get_ip(id)

    def add_dns_record(self, name: str, ip: str) -> None:
        self.dns.add(name, ip)

    def global_ipvs(self) -> IpVirtualServer:
        return self.ipvs

    def stat(self) -> Stat:
        return self.network.stat

    # -- fault injection (ref net/mod.rs:163-284) --------------------------

    def clog_node(self, id: NodeId) -> None:
        self.network.clog_node_in(id)
        self.network.clog_node_out(id)

    def unclog_node(self, id: NodeId) -> None:
        self.network.unclog_node_in(id)
        self.network.unclog_node_out(id)

    def clog_node_in(self, id: NodeId) -> None:
        self.network.clog_node_in(id)

    def clog_node_out(self, id: NodeId) -> None:
        self.network.clog_node_out(id)

    def unclog_node_in(self, id: NodeId) -> None:
        self.network.unclog_node_in(id)

    def unclog_node_out(self, id: NodeId) -> None:
        self.network.unclog_node_out(id)

    def clog_link(self, src: NodeId, dst: NodeId) -> None:
        self.network.clog_link(src, dst)

    def unclog_link(self, src: NodeId, dst: NodeId) -> None:
        self.network.unclog_link(src, dst)

    def hook_rpc_req(self, hook: Hook) -> None:
        """Register a request drop hook (ref net/mod.rs:240-284)."""
        self._rpc_req_hooks.append(hook)

    def hook_rpc_rsp(self, hook: Hook) -> None:
        self._rpc_rsp_hooks.append(hook)

    # -- helpers -----------------------------------------------------------

    def _sleep_ns(self, ns: int) -> Sleep:
        """Raw virtual sleep without the 1 ms tokio minimum."""
        return _new_sleep(self.time, self.time.now_ns + max(0, int(ns)))

    def rand_delay(self) -> Sleep:
        """0-5 µs processing delay; buggified to 1-5 s at 10%
        (ref net/mod.rs:287-295).

        Plain function returning the awaitable Sleep (``await
        ns.rand_delay()`` reads the same): an ``async def`` here costs a
        generator frame + an extra send() dispatch on EVERY message hop
        (twice per delivered message — it's the hottest helper in the
        host-tier profile). Draw order is unchanged: the draws run at
        call time, which under the single-threaded executor is the same
        poll in which the returned Sleep is first awaited."""
        if self.rng.buggify_with_prob(0.1):
            delay_ns = self.rng.gen_range(1_000_000_000, 5_000_000_001)
        else:
            delay_ns = self.rng.gen_range(0, 5_001)
        return self._sleep_ns(delay_ns)

    def resolve_host(self, addr: "str | Addr") -> Addr:
        """DNS-resolve a "host:port" string (ref addr.rs:255-257)."""
        ip, port = parse_addr(addr)
        if ip and not ip[0].isdigit() and ip != "localhost":
            resolved = self.dns.lookup(ip)
            if resolved is None:
                raise OSError(f"failed to lookup address information: {ip}")
            ip = resolved
        elif ip == "localhost":
            ip = "127.0.0.1"
        return (ip, port)

    def _ipvs_rewrite(self, dst: Addr, proto: str) -> Addr:
        svc = ServiceAddr(proto, f"{dst[0]}:{dst[1]}")
        if self.ipvs.has_service(svc):
            server = self.ipvs.get_server(svc)
            if server is None:
                raise ConnectionRefusedError(
                    f"virtual service {svc} has no backend servers"
                )
            return parse_addr(server)
        return dst

    # -- datagram send (ref ``NetSim::send``, net/mod.rs:298-333) ----------

    def _normalize_src(self, src_node: NodeId, src_addr: Addr) -> Addr:
        """Rewrite wildcard source IPs to the node's real IP so replies to
        the reported peer address route back (ref network.rs try_send)."""
        if src_addr[0] in ("0.0.0.0", "::", ""):
            ip = self.network.node_ip.get(src_node)
            if ip is not None:
                return (ip, src_addr[1])
        return src_addr

    async def send_raw(
        self,
        src_node: NodeId,
        src_addr: Addr,
        dst_addr: Addr,
        tag: int,
        payload: Any,
        kind: Optional[str] = None,
    ) -> None:
        src_addr = self._normalize_src(src_node, src_addr)
        await self.rand_delay()
        hooks = (
            self._rpc_req_hooks
            if kind == "rpc_req"
            else self._rpc_rsp_hooks if kind == "rpc_rsp" else []
        )
        for hook in hooks:
            if hook(src_node, dst_addr, tag, payload):
                return  # dropped by hook
        dst_addr = self._ipvs_rewrite(dst_addr, UDP)
        res = self.network.try_send(src_node, dst_addr, UDP)
        if res is None:
            return  # dropped: clog/loss/no socket — datagrams are lossy
        _dst_node, socket, latency = res
        self.time.add_timer(
            latency, lambda: socket.deliver(src_addr, dst_addr, (tag, payload))
        )

    # -- reliable connections (ref net/mod.rs:337-405) ---------------------

    async def connect1(
        self, src_node: NodeId, src_addr: Addr, dst_addr: "str | Addr"
    ) -> Tuple["PipeSender", "PipeReceiver"]:
        """Open a reliable duplex connection to an accepting socket;
        returns the client's (sender, receiver) half."""
        src_addr = self._normalize_src(src_node, src_addr)
        await self.rand_delay()
        dst = self.resolve_host(dst_addr)
        dst = self._ipvs_rewrite(dst, TCP)
        backoff_s = 0.001
        while True:
            dst_node = self.network.resolve_dest_node(src_node, dst[0])
            if dst_node is None:
                raise ConnectionRefusedError(f"no route to host {dst[0]}")
            if not self.network.is_clogged(src_node, dst_node):
                break
            await self._sleep_ns(int(backoff_s * 1e9))
            backoff_s = min(backoff_s * 2, 10.0)
        socket = self.network.find_socket(dst_node, dst, UDP)
        accept_conn = getattr(socket, "accept_connection", None)
        if accept_conn is None:
            raise ConnectionRefusedError(f"connection refused: {dst[0]}:{dst[1]}")

        c2s = _Pipe(self, src_node, dst_node)
        s2c = _Pipe(self, dst_node, src_node)
        self._node_pipes.setdefault(src_node, []).append(c2s)
        self._node_pipes.setdefault(src_node, []).append(s2c)
        self._node_pipes.setdefault(dst_node, []).append(c2s)
        self._node_pipes.setdefault(dst_node, []).append(s2c)
        server_half = (PipeSender(s2c), PipeReceiver(c2s))
        latency = self.network.latency()
        self.network.stat.msg_count += 1
        self.time.add_timer(
            latency, lambda: accept_conn(src_addr, dst, server_half)
        )
        return (PipeSender(c2s), PipeReceiver(s2c))


class _Pipe:
    """One direction of a reliable connection."""

    __slots__ = ("netsim", "src_node", "dst_node", "queue", "closed", "broken",
                 "waiters")

    def __init__(self, netsim: NetSim, src_node: NodeId, dst_node: NodeId):
        self.netsim = netsim
        self.src_node = src_node
        self.dst_node = dst_node
        self.queue: Deque[Any] = deque()
        self.closed = False  # clean EOF from sender
        self.broken = False  # node killed / reset
        self.waiters: List[Future] = []

    def _wake(self) -> None:
        waiters, self.waiters = self.waiters, []
        for fut in waiters:
            fut.set_result(None)

    def _unregister(self) -> None:
        """Drop this pipe from the per-node registries so finished
        connections don't accumulate for the life of the simulation."""
        for nid in (self.src_node, self.dst_node):
            lst = self.netsim._node_pipes.get(nid)
            if lst is not None:
                try:
                    lst.remove(self)
                except ValueError:
                    pass

    def push(self, msg: Any) -> None:
        if self.closed or self.broken:
            raise BrokenPipeError("connection closed")
        self.queue.append(msg)
        self.netsim.network.stat.msg_count += 1
        self._wake()

    def close(self) -> None:
        self.closed = True
        self._wake()
        if not self.queue:
            self._unregister()

    def break_pipe(self) -> None:
        self.broken = True
        self.queue.clear()
        self._wake()
        self._unregister()


class PipeSender:
    """ref ``Sender`` (net/endpoint.rs connection half)."""

    def __init__(self, pipe: _Pipe):
        self._pipe = pipe

    async def send(self, msg: Any) -> None:
        self._pipe.push(msg)

    def close(self) -> None:
        self._pipe.close()

    def is_closed(self) -> bool:
        return self._pipe.closed or self._pipe.broken


class PipeReceiver:
    """Receiver half; re-tests the link per message with exponential
    backoff while clogged (ref net/mod.rs:366-405)."""

    def __init__(self, pipe: _Pipe):
        self._pipe = pipe

    async def recv(self) -> Optional[Any]:
        """Next message; None on clean EOF; ConnectionResetError if the
        peer node was killed."""
        pipe = self._pipe
        netsim = pipe.netsim
        while True:
            if pipe.broken:
                raise ConnectionResetError("connection reset by peer")
            if pipe.queue:
                break
            if pipe.closed:
                pipe._unregister()
                return None
            fut: Future = Future()
            pipe.waiters.append(fut)
            await fut
        # link re-test with exponential backoff 1 ms -> 10 s while clogged
        backoff_s = 0.001
        while netsim.network.is_clogged(pipe.src_node, pipe.dst_node):
            await netsim._sleep_ns(int(backoff_s * 1e9))
            backoff_s = min(backoff_s * 2, 10.0)
            if pipe.broken:
                raise ConnectionResetError("connection reset by peer")
        await netsim._sleep_ns(int(netsim.network.latency() * 1e9))
        if pipe.broken:
            raise ConnectionResetError("connection reset by peer")
        if not pipe.queue:
            return None if pipe.closed else await self.recv()
        return pipe.queue.popleft()

    def close(self) -> None:
        self._pipe.close()
