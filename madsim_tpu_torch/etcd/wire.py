"""etcd v3 gRPC wire: the framework's etcd state machine served over the
REAL etcd protocol (``/etcdserverpb.KV/*``, ``/etcdserverpb.Lease/*``).

The reference's madsim-etcd-client compiles to the *real* etcd-client
crate outside the sim — its std mode speaks actual etcd gRPC. This image
has no etcd server or client library to link against, but it does have
grpcio + protoc, so this module holds the same property from the server
side: ``WireServer`` serves :class:`~madsim_tpu_torch.etcd.service.EtcdService`
(the exact state machine the simulator uses, ref service.rs:189-198)
over genuine gRPC with the etcd v3 message schema, so any stock etcd v3
client — in any language — can Put/Range/DeleteRange/Txn/Compact and
Grant/Revoke/KeepAlive leases against it.

Schema notes: the message/field layout below is transcribed from etcd's
public ``rpc.proto``/``kv.proto`` (field numbers and types must match for
wire compatibility; message *names* need not — a peer never sees this
descriptor). ``mvccpb.KeyValue`` is declared inside the ``etcdserverpb``
package here because one .proto holds one package; the wire bytes are
identical. Scope: the KV, Lease, Watch, and Maintenance services
(Status/Alarm/Defragment/Hash/Snapshot — the surface health tooling
touches; the snapshot blob is this server's JSON dump, see
``_make_maintenance_service``).
Watches deliver current changes only: a FUTURE ``start_revision`` (the
read-then-watch-from-R+1 pattern) is served, with events below the start
suppressed; a PAST one — which would need MVCC history this server does
not keep — is answered with an immediate cancel naming the reason.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

from ..grpc import protogen
from .service import (
    Compare,
    CompareOp,
    DeleteOptions,
    EtcdService,
    GetOptions,
    KeyValue,
    PutOptions,
)

ETCD_PROTO = """
syntax = "proto3";
package etcdserverpb;

// mvccpb.KeyValue, inlined (same field numbers; see module docstring)
message KeyValue {
  bytes key = 1;
  int64 create_revision = 2;
  int64 mod_revision = 3;
  int64 version = 4;
  bytes value = 5;
  int64 lease = 6;
}

message ResponseHeader {
  uint64 cluster_id = 1;
  uint64 member_id = 2;
  int64 revision = 3;
  uint64 raft_term = 4;
}

message RangeRequest {
  enum SortOrder { NONE = 0; ASCEND = 1; DESCEND = 2; }
  enum SortTarget { KEY = 0; VERSION = 1; CREATE = 2; MOD = 3; VALUE = 4; }
  bytes key = 1;
  bytes range_end = 2;
  int64 limit = 3;
  int64 revision = 4;
  SortOrder sort_order = 5;
  SortTarget sort_target = 6;
  bool serializable = 7;
  bool keys_only = 8;
  bool count_only = 9;
  int64 min_mod_revision = 10;
  int64 max_mod_revision = 11;
  int64 min_create_revision = 12;
  int64 max_create_revision = 13;
}

message RangeResponse {
  ResponseHeader header = 1;
  repeated KeyValue kvs = 2;
  bool more = 3;
  int64 count = 4;
}

message PutRequest {
  bytes key = 1;
  bytes value = 2;
  int64 lease = 3;
  bool prev_kv = 4;
  bool ignore_value = 5;
  bool ignore_lease = 6;
}

message PutResponse {
  ResponseHeader header = 1;
  KeyValue prev_kv = 2;
}

message DeleteRangeRequest {
  bytes key = 1;
  bytes range_end = 2;
  bool prev_kv = 3;
}

message DeleteRangeResponse {
  ResponseHeader header = 1;
  int64 deleted = 2;
  repeated KeyValue prev_kvs = 3;
}

message RequestOp {
  oneof request {
    RangeRequest request_range = 1;
    PutRequest request_put = 2;
    DeleteRangeRequest request_delete_range = 3;
    TxnRequest request_txn = 4;
  }
}

message ResponseOp {
  oneof response {
    RangeResponse response_range = 1;
    PutResponse response_put = 2;
    DeleteRangeResponse response_delete_range = 3;
    TxnResponse response_txn = 4;
  }
}

message Compare {
  enum CompareResult { EQUAL = 0; GREATER = 1; LESS = 2; NOT_EQUAL = 3; }
  enum CompareTarget { VERSION = 0; CREATE = 1; MOD = 2; VALUE = 3; LEASE = 4; }
  CompareResult result = 1;
  CompareTarget target = 2;
  bytes key = 3;
  oneof target_union {
    int64 version = 4;
    int64 create_revision = 5;
    int64 mod_revision = 6;
    bytes value = 7;
    int64 lease = 8;
  }
  bytes range_end = 64;
}

message TxnRequest {
  repeated Compare compare = 1;
  repeated RequestOp success = 2;
  repeated RequestOp failure = 3;
}

message TxnResponse {
  ResponseHeader header = 1;
  bool succeeded = 2;
  repeated ResponseOp responses = 3;
}

message CompactionRequest {
  int64 revision = 1;
  bool physical = 2;
}

message CompactionResponse {
  ResponseHeader header = 1;
}

message LeaseGrantRequest {
  int64 TTL = 1;
  int64 ID = 2;
}

message LeaseGrantResponse {
  ResponseHeader header = 1;
  int64 ID = 2;
  int64 TTL = 3;
  string error = 4;
}

message LeaseRevokeRequest { int64 ID = 1; }
message LeaseRevokeResponse { ResponseHeader header = 1; }

message LeaseKeepAliveRequest { int64 ID = 1; }
message LeaseKeepAliveResponse {
  ResponseHeader header = 1;
  int64 ID = 2;
  int64 TTL = 3;
}

message LeaseTimeToLiveRequest {
  int64 ID = 1;
  bool keys = 2;
}
message LeaseTimeToLiveResponse {
  ResponseHeader header = 1;
  int64 ID = 2;
  int64 TTL = 3;
  int64 grantedTTL = 4;
  repeated bytes keys = 5;
}

message LeaseLeasesRequest {}
message LeaseStatus { int64 ID = 1; }
message LeaseLeasesResponse {
  ResponseHeader header = 1;
  repeated LeaseStatus leases = 2;
}

// mvccpb.Event, inlined like KeyValue
message Event {
  enum EventType { PUT = 0; DELETE = 1; }
  EventType type = 1;
  KeyValue kv = 2;
  KeyValue prev_kv = 3;
}

message WatchCreateRequest {
  enum FilterType { NOPUT = 0; NODELETE = 1; }
  bytes key = 1;
  bytes range_end = 2;
  int64 start_revision = 3;
  bool progress_notify = 4;
  repeated FilterType filters = 5;
  bool prev_kv = 6;
  int64 watch_id = 7;
  bool fragment = 8;
}

message WatchCancelRequest { int64 watch_id = 1; }
message WatchProgressRequest {}

message WatchRequest {
  oneof request_union {
    WatchCreateRequest create_request = 1;
    WatchCancelRequest cancel_request = 2;
    WatchProgressRequest progress_request = 3;
  }
}

message WatchResponse {
  ResponseHeader header = 1;
  int64 watch_id = 2;
  bool created = 3;
  bool canceled = 4;
  int64 compact_revision = 5;
  string cancel_reason = 6;
  bool fragment = 7;
  repeated Event events = 11;
}

service KV {
  rpc Range (RangeRequest) returns (RangeResponse);
  rpc Put (PutRequest) returns (PutResponse);
  rpc DeleteRange (DeleteRangeRequest) returns (DeleteRangeResponse);
  rpc Txn (TxnRequest) returns (TxnResponse);
  rpc Compact (CompactionRequest) returns (CompactionResponse);
}

service Lease {
  rpc LeaseGrant (LeaseGrantRequest) returns (LeaseGrantResponse);
  rpc LeaseRevoke (LeaseRevokeRequest) returns (LeaseRevokeResponse);
  rpc LeaseKeepAlive (stream LeaseKeepAliveRequest)
      returns (stream LeaseKeepAliveResponse);
  rpc LeaseTimeToLive (LeaseTimeToLiveRequest)
      returns (LeaseTimeToLiveResponse);
  rpc LeaseLeases (LeaseLeasesRequest) returns (LeaseLeasesResponse);
}

service Watch {
  rpc Watch (stream WatchRequest) returns (stream WatchResponse);
}

message StatusRequest {}
message StatusResponse {
  ResponseHeader header = 1;
  string version = 2;
  int64 dbSize = 3;
  uint64 leader = 4;
  uint64 raftIndex = 5;
  uint64 raftTerm = 6;
  uint64 raftAppliedIndex = 7;
  repeated string errors = 8;
  int64 dbSizeInUse = 9;
  bool isLearner = 10;
}

message AlarmRequest {
  enum AlarmAction { GET = 0; ACTIVATE = 1; DEACTIVATE = 2; }
  AlarmAction action = 1;
  uint64 memberID = 2;
  AlarmType alarm = 3;
}
enum AlarmType { NONE = 0; NOSPACE = 1; CORRUPT = 2; }
message AlarmMember {
  uint64 memberID = 1;
  AlarmType alarm = 2;
}
message AlarmResponse {
  ResponseHeader header = 1;
  repeated AlarmMember alarms = 2;
}

message DefragmentRequest {}
message DefragmentResponse { ResponseHeader header = 1; }

message HashRequest {}
message HashResponse {
  ResponseHeader header = 1;
  uint32 hash = 2;
}

message SnapshotRequest {}
message SnapshotResponse {
  ResponseHeader header = 1;
  uint64 remaining_bytes = 2;
  bytes blob = 3;
}

service Maintenance {
  rpc Alarm (AlarmRequest) returns (AlarmResponse);
  rpc Status (StatusRequest) returns (StatusResponse);
  rpc Defragment (DefragmentRequest) returns (DefragmentResponse);
  rpc Hash (HashRequest) returns (HashResponse);
  rpc Snapshot (SnapshotRequest) returns (stream SnapshotResponse);
}
"""

# etcd's election/lock "concurrency" services live in their own proto
# packages (server/etcdserver/api/v3election, v3lock) and their own
# files here — one .proto holds one package — importing the shared
# header/KeyValue messages from the main schema.
ELECTION_PROTO = """
syntax = "proto3";
package v3electionpb;

import "etcd_wire.proto";

message CampaignRequest {
  bytes name = 1;
  int64 lease = 2;
  bytes value = 3;
}

message LeaderKey {
  bytes name = 1;
  bytes key = 2;
  int64 rev = 3;
  int64 lease = 4;
}

message CampaignResponse {
  etcdserverpb.ResponseHeader header = 1;
  LeaderKey leader = 2;
}

message LeaderRequest { bytes name = 1; }
message LeaderResponse {
  etcdserverpb.ResponseHeader header = 1;
  etcdserverpb.KeyValue kv = 2;
}

message ProclaimRequest {
  LeaderKey leader = 1;
  bytes value = 2;
}
message ProclaimResponse { etcdserverpb.ResponseHeader header = 1; }

message ResignRequest { LeaderKey leader = 1; }
message ResignResponse { etcdserverpb.ResponseHeader header = 1; }

service Election {
  rpc Campaign (CampaignRequest) returns (CampaignResponse);
  rpc Proclaim (ProclaimRequest) returns (ProclaimResponse);
  rpc Leader (LeaderRequest) returns (LeaderResponse);
  rpc Observe (LeaderRequest) returns (stream LeaderResponse);
  rpc Resign (ResignRequest) returns (ResignResponse);
}
"""

LOCK_PROTO = """
syntax = "proto3";
package v3lockpb;

import "etcd_wire.proto";

message LockRequest {
  bytes name = 1;
  int64 lease = 2;
}

message LockResponse {
  etcdserverpb.ResponseHeader header = 1;
  bytes key = 2;
}

message UnlockRequest { bytes key = 1; }
message UnlockResponse { etcdserverpb.ResponseHeader header = 1; }

service Lock {
  rpc Lock (LockRequest) returns (LockResponse);
  rpc Unlock (UnlockRequest) returns (UnlockResponse);
}
"""

_pkg_cache: dict = {}


def wire_pkg() -> protogen.ProtoPackage:
    """The compiled etcd v3 wire schema (once per process — protobuf's
    descriptor pool cannot hold two versions of one file)."""
    if "pkg" not in _pkg_cache:
        d = tempfile.mkdtemp(prefix="etcd_wire_proto")
        paths = []
        for name, text in (
            ("etcd_wire.proto", ETCD_PROTO),
            ("etcd_election.proto", ELECTION_PROTO),
            ("etcd_lock.proto", LOCK_PROTO),
        ):
            path = os.path.join(d, name)
            with open(path, "w") as f:
                f.write(text)
            paths.append(path)
        _pkg_cache["pkg"] = protogen.compile_protos(*paths)
    return _pkg_cache["pkg"]


# -- adapters: protobuf messages <-> the EtcdService surface ----------------

_FROM_END = b"\x00"  # etcd convention: range_end="\0" = every key >= key


def _mk_classes(pkg):
    m = {name.rsplit(".", 1)[-1]: cls for name, cls in pkg.messages.items()}
    return m


def _header(m, svc: EtcdService):
    return m["ResponseHeader"](
        cluster_id=1, member_id=1, revision=svc.revision, raft_term=1
    )


def _wire_kv(m, kv: KeyValue):
    return m["KeyValue"](
        key=kv.key,
        create_revision=kv.create_revision,
        mod_revision=kv.mod_revision,
        version=kv.version,
        value=kv.value,
        lease=kv.lease,
    )


def _get_options(range_end: bytes, **kw) -> GetOptions:
    """The etcd range_end conventions -> GetOptions: empty = single key,
    "\\0" = every key >= key, anything else = half-open [key, range_end)."""
    if range_end == _FROM_END:
        return GetOptions(from_key=True, **kw)
    return GetOptions(range_end=range_end or None, **kw)


_SORT_KEYS = {
    0: lambda kv: kv.key,  # KEY
    1: lambda kv: kv.version,  # VERSION
    2: lambda kv: kv.create_revision,  # CREATE
    3: lambda kv: kv.mod_revision,  # MOD
    4: lambda kv: kv.value,  # VALUE
}


def _guard_range(req) -> None:
    """The one source of truth for unsupported RangeRequest shapes —
    called by the top-level handler AND txn pre-validation, so the two
    can never drift (drift would reintroduce non-atomic txns)."""
    from ..grpc.status import Status

    if req.revision or req.min_mod_revision or req.max_mod_revision or (
        req.min_create_revision or req.max_create_revision
    ):
        # the state machine keeps no MVCC history (current state only,
        # like the reference sim) — fail loudly rather than hand back
        # current data dressed up as a pinned-revision snapshot
        raise Status.unimplemented(
            "etcdserver: historical reads (revision / revision filters) "
            "are not supported by this server; it keeps current state only"
        )


def _guard_put(svc: EtcdService, req) -> None:
    """The one source of truth for PutRequest rejection (see
    _guard_range); mirrors every raise path ``svc.put`` itself has so a
    txn can validate before applying anything."""
    from ..grpc.status import Status
    from .service import MAX_REQUEST_SIZE

    if req.ignore_value or req.ignore_lease:
        raise Status.unimplemented(
            "etcdserver: ignore_value/ignore_lease are not supported here"
        )
    if len(req.key) + len(req.value) > MAX_REQUEST_SIZE:
        raise Status.invalid_argument("etcdserver: request is too large")
    if req.lease and req.lease not in svc.leases:
        raise Status.not_found("etcdserver: requested lease not found")


def _range(m, svc: EtcdService, req):
    _guard_range(req)
    # fetch the FULL range, then sort -> limit -> count_only -> keys_only
    # in etcd's order (sorting after limiting would return the wrong page
    # for descending "latest N" queries)
    _rev, items, count = svc.get(req.key, _get_options(req.range_end))
    if req.sort_order != m["RangeRequest"].SortOrder.NONE:
        items = sorted(
            items,
            key=_SORT_KEYS[int(req.sort_target)],
            reverse=(req.sort_order == m["RangeRequest"].SortOrder.DESCEND),
        )
    if req.limit:
        items = items[: req.limit]
    more = bool(req.limit) and count > len(items)
    if req.count_only:
        items = []
        more = False  # etcd: count_only answers are never "truncated"
    if req.keys_only:
        items = [
            KeyValue(kv.key, b"", kv.create_revision, kv.mod_revision,
                     kv.version, kv.lease)
            for kv in items
        ]
    return m["RangeResponse"](
        header=_header(m, svc),
        kvs=[_wire_kv(m, kv) for kv in items],
        more=more,
        count=count,
    )


def _put(m, svc: EtcdService, req):
    _guard_put(svc, req)
    opts = PutOptions(lease=req.lease, prev_kv=req.prev_kv)
    _rev, prev = svc.put(req.key, req.value, opts)
    out = m["PutResponse"](header=_header(m, svc))
    if prev is not None:
        out.prev_kv.CopyFrom(_wire_kv(m, prev))
    return out


def _delete_options(range_end: bytes, prev_kv: bool) -> DeleteOptions:
    if range_end == _FROM_END:
        return DeleteOptions(from_key=True, prev_kv=prev_kv)
    return DeleteOptions(range_end=range_end or None, prev_kv=prev_kv)


def _delete(m, svc: EtcdService, req):
    # one service.delete whatever the range shape: the whole DeleteRange
    # is one revision, as in etcd
    _rev, deleted, prevs = svc.delete(
        req.key, _delete_options(req.range_end, req.prev_kv)
    )
    return m["DeleteRangeResponse"](
        header=_header(m, svc),
        deleted=deleted,
        prev_kvs=[_wire_kv(m, kv) for kv in prevs],
    )


_CMP_OP = {
    0: CompareOp.EQUAL,
    1: CompareOp.GREATER,
    2: CompareOp.LESS,
    3: CompareOp.NOT_EQUAL,
}
_CMP_TARGET = {
    0: ("version", "version"),
    1: ("create_revision", "create_revision"),
    2: ("mod_revision", "mod_revision"),
    3: ("value", "value"),
    4: ("lease", "lease"),
}


def _compare(req) -> Compare:
    target, operand_field = _CMP_TARGET[req.target]
    return Compare(
        key=req.key,
        target=target,
        op=_CMP_OP[req.result],
        operand=getattr(req, operand_field),
        # range compare (etcd >= 3.3): same range_end conventions
        range_end=(None if req.range_end in (b"", _FROM_END) else req.range_end),
        from_key=req.range_end == _FROM_END,
    )


def _validate_txn(svc: EtcdService, req) -> None:
    """Reject an invalid TxnRequest BEFORE any op applies (etcd validates
    the whole request first; raising mid-branch would leave earlier ops
    committed behind an RPC error — a non-atomic txn on the wire). Covers
    every error path the op handlers can raise: empty ops, unsupported
    revision reads, put guards, oversized puts, and missing leases."""
    from ..grpc.status import Status

    for op in list(req.success) + list(req.failure):
        which = op.WhichOneof("request")
        if which is None:
            raise Status.invalid_argument("etcdserver: missing request op")
        if which == "request_range":
            _guard_range(op.request_range)
        elif which == "request_put":
            _guard_put(svc, op.request_put)
        elif which == "request_txn":
            _validate_txn(svc, op.request_txn)


def _run_txn(m, svc: EtcdService, req, validated: bool = False):
    """Run a TxnRequest by routing each branch op through the SAME wire
    handlers the top-level RPCs use — so sort/limit/more, the from-key
    convention, keys_only, one-revision deletes, and the put guards hold
    identically inside transactions. Atomic: the whole request (both
    branches, recursively) is validated before anything applies, and the
    application itself is synchronous single-threaded code, no awaits."""
    if not validated:
        _validate_txn(svc, req)
    succeeded = all(svc._check(_compare(c)) for c in req.compare)
    return m["TxnResponse"](
        header=_header(m, svc),
        succeeded=succeeded,
        responses=[
            _apply_wire_op(m, svc, op)
            for op in (req.success if succeeded else req.failure)
        ],
    )


def _apply_wire_op(m, svc: EtcdService, op):
    from ..grpc.status import Status

    which = op.WhichOneof("request")
    rop = m["ResponseOp"]()
    if which == "request_range":
        rop.response_range.CopyFrom(_range(m, svc, op.request_range))
    elif which == "request_put":
        rop.response_put.CopyFrom(_put(m, svc, op.request_put))
    elif which == "request_delete_range":
        rop.response_delete_range.CopyFrom(
            _delete(m, svc, op.request_delete_range)
        )
    elif which == "request_txn":
        # already validated recursively by the outermost _run_txn
        rop.response_txn.CopyFrom(
            _run_txn(m, svc, op.request_txn, validated=True)
        )
    else:
        # unreachable after _validate_txn, kept as a hard backstop
        raise Status.invalid_argument("etcdserver: missing request op")
    return rop


def _make_services(pkg, svc: EtcdService):
    """The KV + Lease wire service classes bound to one EtcdService."""
    m = _mk_classes(pkg)

    @pkg.implement("etcdserverpb.KV")
    class KVWire:
        async def range(self, request):
            return _range(m, svc, request.message)

        async def put(self, request):
            return _put(m, svc, request.message)

        async def delete_range(self, request):
            return _delete(m, svc, request.message)

        async def txn(self, request):
            return _run_txn(m, svc, request.message)

        async def compact(self, request):
            svc.compact(request.message.revision)
            return m["CompactionResponse"](header=_header(m, svc))

    @pkg.implement("etcdserverpb.Lease")
    class LeaseWire:
        async def lease_grant(self, request):
            req = request.message
            lease_id, ttl = svc.lease_grant(req.TTL, req.ID)
            return m["LeaseGrantResponse"](
                header=_header(m, svc), ID=lease_id, TTL=ttl
            )

        async def lease_revoke(self, request):
            svc.lease_revoke(request.message.ID)
            return m["LeaseRevokeResponse"](header=_header(m, svc))

        async def lease_keep_alive(self, stream):
            from ..grpc.status import Status

            async for req in stream:
                try:
                    lease_id, ttl = svc.lease_keep_alive(req.ID)
                except Status:
                    # real etcd answers an expired/unknown lease with
                    # TTL=-1 and KEEPS the stream alive (clients read
                    # TTL<=0 as "lease gone"; a stream error would look
                    # like a retryable transport failure instead)
                    yield m["LeaseKeepAliveResponse"](
                        header=_header(m, svc), ID=req.ID, TTL=-1
                    )
                    continue
                yield m["LeaseKeepAliveResponse"](
                    header=_header(m, svc), ID=lease_id, TTL=ttl
                )

        async def lease_time_to_live(self, request):
            req = request.message
            lease_id, remaining, granted, keys = svc.lease_time_to_live(req.ID)
            return m["LeaseTimeToLiveResponse"](
                header=_header(m, svc),
                ID=lease_id,
                TTL=remaining,
                grantedTTL=granted,
                keys=list(keys) if req.keys else [],
            )

        async def lease_leases(self, request):
            return m["LeaseLeasesResponse"](
                header=_header(m, svc),
                leases=[m["LeaseStatus"](ID=i) for i in svc.lease_leases()],
            )

    return KVWire(), LeaseWire()


def _make_maintenance_service(pkg, svc: EtcdService):
    """The Maintenance surface health tooling touches (``etcdctl endpoint
    status``, clientv3 health checks): Status, Alarm (always clear),
    Defragment (a no-op on an in-memory store), Hash (over the state
    dump), and Snapshot. The snapshot BLOB is this server's own JSON dump
    (restorable via ``EtcdService.load``), not a bbolt database — the
    stream protocol is etcd's, the payload format is declared here."""
    import zlib

    m = _mk_classes(pkg)

    def _kv_hash() -> int:
        """A function of KV state ONLY — the dump also carries live
        leases' decaying ``remaining`` counters, which would make the
        hash drift every wall-clock second and defeat its purpose
        (comparing across calls/members to detect divergence)."""
        acc = 0
        for key in sorted(svc.kv):
            kv = svc.kv[key]
            acc = zlib.crc32(
                b"%b\x00%b\x00%d\x00%d\x00%d\x00%d" % (
                    kv.key, kv.value, kv.create_revision, kv.mod_revision,
                    kv.version, kv.lease,
                ),
                acc,
            )
        return zlib.crc32(str(svc.revision).encode(), acc)

    @pkg.implement("etcdserverpb.Maintenance")
    class MaintenanceWire:
        async def status(self, request):
            dump = svc.dump().encode()
            return m["StatusResponse"](
                header=_header(m, svc),
                version="3.5.0-madsim",
                dbSize=len(dump),
                dbSizeInUse=len(dump),
                leader=1,
                raftIndex=max(svc.revision, 1),
                raftTerm=1,
                raftAppliedIndex=max(svc.revision, 1),
            )

        async def alarm(self, request):
            # an in-memory store never raises NOSPACE/CORRUPT; every
            # action observes (and "clears") an empty alarm list
            return m["AlarmResponse"](header=_header(m, svc), alarms=[])

        async def defragment(self, request):
            return m["DefragmentResponse"](header=_header(m, svc))

        async def hash(self, request):
            return m["HashResponse"](
                header=_header(m, svc), hash=_kv_hash()
            )

        async def snapshot(self, request):
            blob = svc.dump().encode()
            chunk = 32 * 1024
            for i in range(0, max(len(blob), 1), chunk):
                part = blob[i:i + chunk]
                yield m["SnapshotResponse"](
                    header=_header(m, svc),
                    remaining_bytes=max(0, len(blob) - (i + len(part))),
                    blob=part,
                )

    return MaintenanceWire()


def _make_watch_service(pkg, svc: EtcdService):
    """The Watch bidi service: multiplexes create/cancel control messages
    with event delivery on one response stream, as etcd does. Each watch
    subscribes to the service EventBus (everything) and filters by its
    own key range — range watches work even though the bus itself only
    knows exact/prefix subscriptions."""
    import asyncio

    from .service import EventType

    m = _mk_classes(pkg)

    def _matches(create, key: bytes) -> bool:
        if create.range_end == b"":
            return key == create.key
        if create.range_end == _FROM_END:
            return key >= create.key
        return create.key <= key < create.range_end

    @pkg.implement("etcdserverpb.Watch")
    class WatchWire:
        async def watch(self, stream):
            out: asyncio.Queue = asyncio.Queue()
            pumps: dict = {}  # watch_id -> (bus watcher, pump task)
            next_id = [1]
            loop = asyncio.get_running_loop()

            async def pump(wid: int, create, watcher,
                           min_rev: int = 0) -> None:
                nofilter = set(int(f) for f in create.filters)
                while True:
                    ev = await watcher.next()
                    if not _matches(create, ev.kv.key):
                        continue
                    if min_rev and ev.kv.mod_revision < min_rev:
                        # future start_revision: suppress events below it
                        # (the read-then-watch-from-R+1 pattern expects
                        # exactly the events at revision >= R+1)
                        continue
                    is_put = ev.type == EventType.PUT
                    if (is_put and 0 in nofilter) or (
                        not is_put and 1 in nofilter
                    ):
                        continue  # FilterType NOPUT=0 / NODELETE=1
                    wev = m["Event"](
                        type=(m["Event"].EventType.PUT if is_put
                              else m["Event"].EventType.DELETE),
                        kv=_wire_kv(m, ev.kv),
                    )
                    if create.prev_kv and ev.prev_kv is not None:
                        wev.prev_kv.CopyFrom(_wire_kv(m, ev.prev_kv))
                    await out.put(m["WatchResponse"](
                        header=_header(m, svc), watch_id=wid, events=[wev]
                    ))

            async def reader() -> None:
                try:
                    async for req in stream:
                        which = req.WhichOneof("request_union")
                        if which == "create_request":
                            c = req.create_request
                            wid = c.watch_id or next_id[0]
                            next_id[0] = max(next_id[0], wid) + 1
                            if wid in pumps:
                                # etcd rejects duplicate explicit ids; a
                                # silent overwrite would leak the old bus
                                # subscription and deliver events twice
                                await out.put(m["WatchResponse"](
                                    header=_header(m, svc), watch_id=wid,
                                    canceled=True,
                                    cancel_reason=(
                                        "duplicated watch_id provided"
                                    ),
                                ))
                                continue
                            if 0 < c.start_revision <= svc.revision:
                                # past revisions need MVCC history we do
                                # not keep; a FUTURE start_revision (the
                                # canonical read-then-watch-from-R+1
                                # pattern) needs none and is served below
                                await out.put(m["WatchResponse"](
                                    header=_header(m, svc), watch_id=wid,
                                    created=True, canceled=True,
                                    cancel_reason=(
                                        "historical watch is not supported "
                                        "by this server (no MVCC history)"
                                    ),
                                ))
                                continue
                            watcher = svc.bus.subscribe(b"", True)
                            pumps[wid] = (
                                watcher,
                                loop.create_task(
                                    pump(wid, c, watcher,
                                         min_rev=c.start_revision)
                                ),
                            )
                            await out.put(m["WatchResponse"](
                                header=_header(m, svc), watch_id=wid,
                                created=True,
                            ))
                        elif which == "cancel_request":
                            wid = req.cancel_request.watch_id
                            entry = pumps.pop(wid, None)
                            if entry is not None:
                                entry[0].cancel()
                                entry[1].cancel()
                            await out.put(m["WatchResponse"](
                                header=_header(m, svc), watch_id=wid,
                                canceled=True,
                            ))
                        else:  # progress request
                            await out.put(m["WatchResponse"](
                                header=_header(m, svc), watch_id=-1
                            ))
                finally:
                    await out.put(None)  # client closed its request side

            rtask = loop.create_task(reader())
            try:
                while True:
                    item = await out.get()
                    if item is None:
                        return
                    yield item
            finally:
                rtask.cancel()
                for watcher, task in pumps.values():
                    watcher.cancel()
                    task.cancel()

    return WatchWire()


async def acquire_candidacy(
    svc: EtcdService, name: bytes, value: bytes, lease: int
) -> bytes:
    """The blocking half of Campaign/Lock: write our candidacy key and
    wait until it is the OLDEST (lowest create_revision) under the
    prefix. Subscribes BEFORE each try so a delete landing between the
    try and the wait cannot be missed; only deletions (resign, unlock,
    lease expiry) can change who is oldest, so only they wake the loop.
    Module-level (not closed over a compiled proto package) so the
    recipe's semantics are testable without protoc."""
    from .service import EventType

    while True:
        watcher = svc.bus.subscribe(name + b"/", True)
        try:
            key = svc.campaign_try(name, value, lease)
            if key is not None:
                return key
            while True:
                ev = await watcher.next()
                if ev.type == EventType.DELETE:
                    break  # a candidate left — re-evaluate leadership
        finally:
            watcher.cancel()


def _make_concurrency_services(pkg, svc: EtcdService):
    """The v3election/v3lock "concurrency" services, on the exact recipe
    real etcd's run on: a candidate key ``name + "/" + hex(lease)`` under
    the election prefix, leadership to the LOWEST create_revision, and
    blocking by watching the prefix for deletions (resign, unlock, or
    lease expiry) before re-trying. ``EtcdService`` already holds the
    primitives (campaign_try/election_leader/proclaim/resign,
    service.rs:487-583); these classes put them on the wire."""
    from ..grpc.status import Status
    from .service import DeleteOptions

    m = _mk_classes(pkg)

    async def _acquire(name: bytes, value: bytes, lease: int) -> bytes:
        return await acquire_candidacy(svc, name, value, lease)

    @pkg.implement("v3electionpb.Election")
    class ElectionWire:
        async def campaign(self, request):
            req = request.message
            key = await _acquire(req.name, req.value, req.lease)
            kv = svc.kv[key]
            return m["CampaignResponse"](
                header=_header(m, svc),
                leader=m["LeaderKey"](
                    name=req.name, key=key,
                    rev=kv.create_revision, lease=req.lease,
                ),
            )

        async def proclaim(self, request):
            req = request.message
            svc.proclaim(req.leader.key, req.value)  # gone key -> error
            return m["ProclaimResponse"](header=_header(m, svc))

        async def leader(self, request):
            kv = svc.election_leader(request.message.name)
            if kv is None:
                raise Status.not_found("election: no leader")
            return m["LeaderResponse"](
                header=_header(m, svc), kv=_wire_kv(m, kv)
            )

        async def observe(self, request):
            name = request.message.name
            watcher = svc.bus.subscribe(name + b"/", True)
            last = None
            try:
                while True:
                    kv = svc.election_leader(name)
                    if kv is not None and (kv.key, kv.mod_revision) != last:
                        last = (kv.key, kv.mod_revision)
                        yield m["LeaderResponse"](
                            header=_header(m, svc), kv=_wire_kv(m, kv)
                        )
                    await watcher.next()
            finally:
                watcher.cancel()

        async def resign(self, request):
            # resigning a key that is already gone is a no-op, as in etcd
            svc.resign(request.message.leader.key)
            return m["ResignResponse"](header=_header(m, svc))

    @pkg.implement("v3lockpb.Lock")
    class LockWire:
        async def lock(self, request):
            req = request.message
            key = await _acquire(req.name, b"", req.lease)
            return m["LockResponse"](header=_header(m, svc), key=key)

        async def unlock(self, request):
            svc.delete(request.message.key, DeleteOptions())
            return m["UnlockResponse"](header=_header(m, svc))

    return ElectionWire(), LockWire()


class WireServer:
    """Serve an :class:`EtcdService` over genuine etcd v3 gRPC wire
    (real mode: grpc.aio transport + wall-clock lease ticks).

    Deliberately NOT on the shared serving core (``madsim_tpu_torch/serve/``):
    grpc.aio owns its HTTP/2 accept loop, flow control, and framing
    end-to-end, so there is no seam to plug an adapter into. The framed
    etcd tier (``real/etcd.py``) — same EtcdService, same dispatcher —
    is the one the core multiplexes; see docs/wire.md.
    """

    def __init__(self, service: Optional[EtcdService] = None):
        self.service = service or EtcdService()
        self.bound_addr: "tuple | None" = None

    async def serve(self, addr: "str | tuple") -> None:
        from ..real import time as rtime
        from ..real.grpc import GrpcioServer
        from ..real.runtime import spawn

        import asyncio

        # watchers block on asyncio futures here, not sim futures
        self.service.bus.future_factory = (
            lambda: asyncio.get_running_loop().create_future()
        )
        pkg = wire_pkg()
        kv, lease = _make_services(pkg, self.service)
        election, lock = _make_concurrency_services(pkg, self.service)
        router = (
            GrpcioServer.builder()
            .add_service(kv)
            .add_service(lease)
            .add_service(_make_watch_service(pkg, self.service))
            .add_service(_make_maintenance_service(pkg, self.service))
            .add_service(election)
            .add_service(lock)
        )

        async def tick_loop() -> None:
            while True:
                await rtime.sleep(1.0)
                self.service.tick()

        tick = spawn(tick_loop(), name="etcd-wire-tick")
        serve_task = spawn(router.serve(addr), name="etcd-wire-serve")
        try:
            while router.bound_addr is None:
                if serve_task.done():
                    serve_task.result()
                await rtime.sleep(0.005)
            self.bound_addr = router.bound_addr
            await serve_task
        finally:
            tick.abort()
            serve_task.abort()
