"""etcd v3 simulation — the madsim-etcd-client analogue.

A deterministic in-sim etcd: the client issues one ``connect1`` exchange
per operation against a ``SimServer`` node holding the whole service state
(madsim-etcd-client/src/{sim.rs,server.rs,service.rs}):

- **kv**: put / range-get (prefix) / delete / txn (compares + nested ops) /
  compact, with etcd's revision bookkeeping (global revision,
  create_revision / mod_revision per key)
- **lease**: grant / revoke / keep-alive / time-to-live, with a TTL tick
  task expiring leases (and their attached keys) every simulated second
  (service.rs:27-33,466-485)
- **election**: campaign / proclaim / leader / observe / resign built on a
  prefix-watch event bus (service.rs:487-583)
- **watch**: prefix watch streams (the event bus made public)
- **maintenance**: status, and the state **dump/load** snapshot-restore
  the reference exposes for checkpointing (service.rs:160-163)
- fault injection: ``timeout_rate`` — a random 5-15 s delay then
  Unavailable on any request (service.rs:165-176)
- 1.5 MiB max request size (service.rs:36)

Errors are ``grpc.Status`` values, matching the reference's use of tonic
``Status`` as the etcd error surface.
"""

from .client import (
    CampaignResponse,
    Client,
    ConnectOptions,
    DeleteResponse,
    ElectionClient,
    GetResponse,
    KvClient,
    LeaderKey,
    LeaderResponse,
    LeaseClient,
    LeaseGrantResponse,
    LeaseKeepAliveResponse,
    LeaseTimeToLiveResponse,
    MaintenanceClient,
    ObserveStream,
    PutResponse,
    ResponseHeader,
    StatusResponse,
    TxnResponse,
    WatchClient,
    WatchStream,
)
from .server import SimServer
from .service import (
    Compare,
    CompareOp,
    DeleteOptions,
    Event,
    EventType,
    GetOptions,
    KeyValue,
    PutOptions,
    Txn,
    TxnOp,
)

__all__ = [
    "CampaignResponse",
    "Client",
    "Compare",
    "CompareOp",
    "ConnectOptions",
    "DeleteOptions",
    "DeleteResponse",
    "ElectionClient",
    "Event",
    "EventType",
    "GetOptions",
    "GetResponse",
    "KeyValue",
    "KvClient",
    "LeaderKey",
    "LeaderResponse",
    "LeaseClient",
    "LeaseGrantResponse",
    "LeaseKeepAliveResponse",
    "LeaseTimeToLiveResponse",
    "MaintenanceClient",
    "ObserveStream",
    "PutOptions",
    "PutResponse",
    "ResponseHeader",
    "SimServer",
    "StatusResponse",
    "Txn",
    "TxnOp",
    "TxnResponse",
    "WatchClient",
    "WatchStream",
]
