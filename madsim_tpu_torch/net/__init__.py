"""Simulated network stack (ref madsim/src/sim/net/).

Layering (bottom-up): ``network`` (pure link-state model) → ``netsim``
(plugin: fault API + timer-scheduled delivery + reliable channels) →
``endpoint`` (tag-matching messaging) → ``rpc``/``tcp``/``udp`` protocol
shims, with ``dns``/``ipvs`` as auxiliary services.
"""

from .dns import DnsServer
from .endpoint import BindGuard, Endpoint, Mailbox, lookup_host
from .ipvs import IpVirtualServer, ServiceAddr
from .netsim import NetSim, PipeReceiver, PipeSender
from .network import Addr, Network, Stat, format_addr, parse_addr
from .rpc import Request, hash_str, rpc_method, service
from .tcp import TcpListener, TcpStream
from .udp import UdpSocket
from .unix import UnixDatagram, UnixListener, UnixStream

__all__ = [
    "Addr",
    "BindGuard",
    "DnsServer",
    "Endpoint",
    "IpVirtualServer",
    "Mailbox",
    "NetSim",
    "Network",
    "PipeReceiver",
    "PipeSender",
    "Request",
    "ServiceAddr",
    "Stat",
    "TcpListener",
    "TcpStream",
    "UdpSocket",
    "UnixDatagram",
    "UnixListener",
    "UnixStream",
    "format_addr",
    "hash_str",
    "lookup_host",
    "parse_addr",
    "rpc_method",
    "service",
]
