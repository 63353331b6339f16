"""Genuine Kafka binary wire protocol: the framework's ``Broker`` state
machine served over the REAL Kafka protocol, so a stock Kafka client can
connect, produce, fetch, and run a full consumer-group session against
it on either tier.

The reference's madsim-rdkafka compiles to the *real* rdkafka bindings
outside the sim — its std mode speaks the actual Kafka wire. No
librdkafka exists in this image, so this module holds the property from
the server side (the same move as ``etcd/wire.py`` for etcd gRPC and
``s3/wire.py`` for S3 REST): 4-byte big-endian length framing,
request/response headers with correlation ids (v1 and the v2
flexible/compact-tagged-field form), record-batch **v2** encoding with
CRC32C (Castagnoli, table-driven — no native crc32c dependency), and the
version-gated field layouts of the APIs below.

Advertised API matrix (``ApiVersions`` reports exactly this; ``flex`` is
the first flexible version served, ``-`` = none in the advertised span):

    ==================  ===  =========  ====
    API                 key  versions   flex
    ==================  ===  =========  ====
    Produce               0  3–7        -
    Fetch                 1  4–10       -
    ListOffsets           2  1–5        -
    Metadata              3  0–5        -
    OffsetCommit          8  2–5        -
    OffsetFetch           9  1–5        -
    FindCoordinator      10  0–3        3
    JoinGroup            11  0–5        -
    Heartbeat            12  0–4        4
    LeaveGroup           13  0–3        -
    SyncGroup            14  0–3        -
    ApiVersions          18  0–3        3
    CreateTopics         19  0–4        -
    DeleteTopics         20  0–3        -
    ==================  ===  =========  ====

Scope notes (deliberate test-double boundaries, like the S3 wire's):
this is a single-node "cluster" (node 0 is every partition's leader and
the one group coordinator), record batches are uncompressed (compressed
batches are refused loudly, never mis-decoded), Fetch answers
immediately (no ``max_wait``/``min_bytes`` long-poll parking) and clamps
out-of-range offsets to the log bounds exactly like the broker state
machine does, and the group coordinator ASSIGNS server-side: JoinGroup
keeps the classic shape (leader election, member-metadata echo) but
SyncGroup returns the broker's own deterministic range assignment,
ignoring leader-supplied assignments — identical subscriptions make a
stock client's RangeAssignor agree byte-for-byte anyway, and sim
schedules stay reproducible. Rejoining with an unchanged subscription
does not bump the generation (static-membership-flavored), which is what
lets a heartbeat-triggered rejoin converge instead of storming.

Two tiers, one engine: ``KafkaWire.handle_frame`` is a pure function of
(request bytes, clock) — ``SimWireServer`` serves it over the Endpoint /
``connect1`` pipe plumbing (bytes chunks over sim channels), and
``WireServer`` over real TCP via asyncio streams with the frame helpers
in ``real/stream.py``. Purity is the determinism story: a recorded (frame, clock) transcript
re-fed through a fresh broker gives byte-identical responses
(``KafkaWire.recorder`` records one).
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, List, Optional, Tuple

from .broker import Broker, KafkaBrokerError

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — table-driven, reflected poly 0x82F63B78. Pure
# Python on purpose: the container has no crc32c wheel, and record-batch
# volumes here (tests + smoke gates) are far below the point where a
# native implementation would matter.

_CRC32C_TABLE: List[int] = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC32C_TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# primitive codec

_I8 = struct.Struct(">b")
_I16 = struct.Struct(">h")
_I32 = struct.Struct(">i")
_I64 = struct.Struct(">q")
_U32 = struct.Struct(">I")


class WireError(Exception):
    """A frame this server refuses to parse/serve — the connection dies,
    like a protocol violation against a real broker."""


class Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise WireError(f"truncated frame (want {n} bytes at {self.pos})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def remaining(self) -> int:
        return len(self.data) - self.pos

    def i8(self) -> int:
        return _I8.unpack(self.read(1))[0]

    def i16(self) -> int:
        return _I16.unpack(self.read(2))[0]

    def i32(self) -> int:
        return _I32.unpack(self.read(4))[0]

    def i64(self) -> int:
        return _I64.unpack(self.read(8))[0]

    def u32(self) -> int:
        return _U32.unpack(self.read(4))[0]

    def boolean(self) -> bool:
        return self.i8() != 0

    def uvarint(self) -> int:
        out = shift = 0
        while True:
            b = self.read(1)[0]
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise WireError("varint overflow")

    def varint(self) -> int:
        v = self.uvarint()
        return (v >> 1) ^ -(v & 1)

    varlong = varint  # same zigzag encoding, wider range

    def string(self) -> str:
        n = self.i16()
        if n < 0:
            raise WireError("null where a non-null string is required")
        return self.read(n).decode("utf-8")

    def nullable_string(self) -> Optional[str]:
        n = self.i16()
        return None if n < 0 else self.read(n).decode("utf-8")

    def bytes32(self) -> bytes:
        n = self.i32()
        if n < 0:
            raise WireError("null where non-null bytes are required")
        return bytes(self.read(n))

    def nullable_bytes(self) -> Optional[bytes]:
        n = self.i32()
        return None if n < 0 else bytes(self.read(n))

    def compact_string(self) -> str:
        n = self.uvarint() - 1
        if n < 0:
            raise WireError("null where a non-null compact string is required")
        return self.read(n).decode("utf-8")

    def compact_nullable_string(self) -> Optional[str]:
        n = self.uvarint() - 1
        return None if n < 0 else self.read(n).decode("utf-8")

    def compact_bytes(self) -> bytes:
        n = self.uvarint() - 1
        if n < 0:
            raise WireError("null where non-null compact bytes are required")
        return bytes(self.read(n))

    def array(self, fn: Callable[[], Any]) -> Optional[list]:
        n = self.i32()
        if n < 0:
            return None
        if n > 1_000_000:
            raise WireError(f"implausible array length {n}")
        return [fn() for _ in range(n)]

    def compact_array(self, fn: Callable[[], Any]) -> Optional[list]:
        n = self.uvarint() - 1
        if n < 0:
            return None
        if n > 1_000_000:
            raise WireError(f"implausible array length {n}")
        return [fn() for _ in range(n)]

    def tagged_fields(self) -> None:
        for _ in range(self.uvarint()):
            self.uvarint()  # tag
            self.read(self.uvarint())  # value


class Writer:
    __slots__ = ("b",)

    def __init__(self) -> None:
        self.b = bytearray()

    def raw(self, data: bytes) -> "Writer":
        self.b += data
        return self

    def i8(self, v: int) -> "Writer":
        self.b += _I8.pack(v)
        return self

    def i16(self, v: int) -> "Writer":
        self.b += _I16.pack(v)
        return self

    def i32(self, v: int) -> "Writer":
        self.b += _I32.pack(v)
        return self

    def i64(self, v: int) -> "Writer":
        self.b += _I64.pack(v)
        return self

    def u32(self, v: int) -> "Writer":
        self.b += _U32.pack(v)
        return self

    def boolean(self, v: bool) -> "Writer":
        return self.i8(1 if v else 0)

    def uvarint(self, v: int) -> "Writer":
        while True:
            if v < 0x80:
                self.b.append(v)
                return self
            self.b.append((v & 0x7F) | 0x80)
            v >>= 7

    def varint(self, v: int) -> "Writer":
        return self.uvarint((v << 1) ^ (v >> 63) if v < 0 else v << 1)

    varlong = varint

    def string(self, s: str) -> "Writer":
        raw = s.encode("utf-8")
        return self.i16(len(raw)).raw(raw)

    def nullable_string(self, s: Optional[str]) -> "Writer":
        return self.i16(-1) if s is None else self.string(s)

    def bytes32(self, data: bytes) -> "Writer":
        return self.i32(len(data)).raw(data)

    def nullable_bytes(self, data: Optional[bytes]) -> "Writer":
        return self.i32(-1) if data is None else self.bytes32(data)

    def compact_string(self, s: str) -> "Writer":
        raw = s.encode("utf-8")
        return self.uvarint(len(raw) + 1).raw(raw)

    def compact_nullable_string(self, s: Optional[str]) -> "Writer":
        return self.uvarint(0) if s is None else self.compact_string(s)

    def compact_bytes(self, data: bytes) -> "Writer":
        return self.uvarint(len(data) + 1).raw(data)

    def array(self, items, fn: Callable[["Writer", Any], Any]) -> "Writer":
        self.i32(len(items))
        for it in items:
            fn(self, it)
        return self

    def compact_array(self, items, fn: Callable[["Writer", Any], Any]) -> "Writer":
        self.uvarint(len(items) + 1)
        for it in items:
            fn(self, it)
        return self

    def tagged_fields(self) -> "Writer":
        return self.uvarint(0)

    def done(self) -> bytes:
        return bytes(self.b)


# version-aware string/array: one call site per field, the flexible flag
# picks the encoding — the two wire forms can never drift apart per field
def wstr(w: Writer, s: str, flex: bool) -> None:
    (w.compact_string if flex else w.string)(s)


def wnstr(w: Writer, s: Optional[str], flex: bool) -> None:
    (w.compact_nullable_string if flex else w.nullable_string)(s)


def warr(w: Writer, items, fn, flex: bool) -> None:
    (w.compact_array if flex else w.array)(items, fn)


def rstr(r: Reader, flex: bool) -> str:
    return r.compact_string() if flex else r.string()


def rnstr(r: Reader, flex: bool) -> Optional[str]:
    return r.compact_nullable_string() if flex else r.nullable_string()


def rarr(r: Reader, fn, flex: bool) -> Optional[list]:
    return r.compact_array(fn) if flex else r.array(fn)


# ---------------------------------------------------------------------------
# record batch v2 (magic 2) — the modern on-wire record format

#: (timestamp_ms, key|None, value|None) — the record triple both codec
#: directions and the probe client speak
Record = Tuple[int, Optional[bytes], Optional[bytes]]


def encode_record_batch(base_offset: int, records: List[Record]) -> bytes:
    """One uncompressed v2 batch; CRC32C covers attributes..end, exactly
    the span the spec names."""
    if not records:
        return b""
    body = Writer()
    body.i16(0)  # attributes: no compression, CREATE_TIME, not txn
    body.i32(len(records) - 1)  # lastOffsetDelta
    base_ts = records[0][0]
    body.i64(base_ts)
    body.i64(max(ts for ts, _k, _v in records))
    body.i64(-1).i16(-1).i32(-1)  # producerId / producerEpoch / baseSequence
    body.i32(len(records))
    for i, (ts, key, val) in enumerate(records):
        rec = Writer()
        rec.i8(0)  # record attributes
        rec.varlong(ts - base_ts)
        rec.varint(i)  # offsetDelta
        for blob in (key, val):
            if blob is None:
                rec.varint(-1)
            else:
                rec.varint(len(blob)).raw(blob)
        rec.varint(0)  # headers
        body.varint(len(rec.b)).raw(rec.b)
    out = Writer()
    out.i64(base_offset)
    out.i32(4 + 1 + 4 + len(body.b))  # partitionLeaderEpoch + magic + crc + rest
    out.i32(-1)  # partitionLeaderEpoch
    out.i8(2)  # magic
    out.u32(crc32c(bytes(body.b)))
    out.raw(body.b)
    return out.done()


def decode_record_batches(data: bytes) -> List[Tuple[int, int, Optional[bytes], Optional[bytes]]]:
    """Decode a concatenation of v2 batches into (offset, ts, key, value)
    rows, verifying each batch's CRC32C. Older magic or compressed
    batches are refused loudly."""
    out: List[Tuple[int, int, Optional[bytes], Optional[bytes]]] = []
    r = Reader(data)
    while r.remaining() > 0:
        if r.remaining() < 12:
            raise WireError("trailing garbage after last record batch")
        base = r.i64()
        batch = r.read(r.i32())
        br = Reader(batch)
        br.i32()  # partitionLeaderEpoch
        magic = br.i8()
        if magic != 2:
            raise WireError(f"unsupported record format magic {magic} (v2 only)")
        crc = br.u32()
        payload = batch[br.pos:]
        if crc32c(payload) != crc:
            raise WireError("record batch CRC32C mismatch")
        attrs = br.i16()
        if attrs & 0x07:
            raise WireError("compressed record batches are not supported")
        br.i32()  # lastOffsetDelta
        base_ts = br.i64()
        br.i64()  # maxTimestamp
        br.i64(); br.i16(); br.i32()  # producer id / epoch / base sequence
        for _ in range(br.i32()):
            rr = Reader(br.read(br.varint()))
            rr.i8()  # record attributes
            ts = base_ts + rr.varlong()
            off = base + rr.varint()
            kl = rr.varint()
            key = bytes(rr.read(kl)) if kl >= 0 else None
            vl = rr.varint()
            val = bytes(rr.read(vl)) if vl >= 0 else None
            for _h in range(max(rr.varint(), 0)):  # headers: skipped
                rr.read(max(rr.varint(), 0))
                rr.read(max(rr.varint(), 0))
            out.append((off, ts, key, val))
    return out


# ---------------------------------------------------------------------------
# consumer-protocol blobs (the opaque bytes inside JoinGroup/SyncGroup)


def encode_subscription(topics: List[str]) -> bytes:
    w = Writer()
    w.i16(0)  # ConsumerProtocolSubscription version
    w.array(sorted(topics), lambda ww, t: ww.string(t))
    w.i32(-1)  # user_data
    return w.done()


def decode_subscription(blob: bytes) -> List[str]:
    r = Reader(blob)
    r.i16()  # version — every version starts (version, [topics], ...)
    return list(r.array(r.string) or [])


def encode_assignment(tps: List[Tuple[str, int]]) -> bytes:
    by_topic: Dict[str, List[int]] = {}
    for t, p in tps:
        by_topic.setdefault(t, []).append(p)
    w = Writer()
    w.i16(0)  # ConsumerProtocolAssignment version
    w.i32(len(by_topic))
    for t in sorted(by_topic):
        w.string(t)
        w.array(sorted(by_topic[t]), lambda ww, p: ww.i32(p))
    w.i32(-1)  # user_data
    return w.done()


def decode_assignment(blob: bytes) -> List[Tuple[str, int]]:
    r = Reader(blob)
    r.i16()
    out: List[Tuple[str, int]] = []
    for _ in range(r.i32()):
        t = r.string()
        out.extend((t, p) for p in (r.array(r.i32) or []))
    return out


# ---------------------------------------------------------------------------
# API keys, version matrix, error codes

API_PRODUCE = 0
API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_OFFSET_COMMIT = 8
API_OFFSET_FETCH = 9
API_FIND_COORDINATOR = 10
API_JOIN_GROUP = 11
API_HEARTBEAT = 12
API_LEAVE_GROUP = 13
API_SYNC_GROUP = 14
API_VERSIONS = 18
API_CREATE_TOPICS = 19
API_DELETE_TOPICS = 20

#: api_key -> (min_version, max_version, first_flexible_version | None)
SUPPORTED_APIS: Dict[int, Tuple[int, int, Optional[int]]] = {
    API_PRODUCE: (3, 7, None),
    API_FETCH: (4, 10, None),
    API_LIST_OFFSETS: (1, 5, None),
    API_METADATA: (0, 5, None),
    API_OFFSET_COMMIT: (2, 5, None),
    API_OFFSET_FETCH: (1, 5, None),
    API_FIND_COORDINATOR: (0, 3, 3),
    API_JOIN_GROUP: (0, 5, None),
    API_HEARTBEAT: (0, 4, 4),
    API_LEAVE_GROUP: (0, 3, None),
    API_SYNC_GROUP: (0, 3, None),
    API_VERSIONS: (0, 3, 3),
    API_CREATE_TOPICS: (0, 4, None),
    API_DELETE_TOPICS: (0, 3, None),
}

#: api_key -> wire name, for telemetry labels (obs/metrics.py)
API_NAMES: Dict[int, str] = {
    API_PRODUCE: "Produce",
    API_FETCH: "Fetch",
    API_LIST_OFFSETS: "ListOffsets",
    API_METADATA: "Metadata",
    API_OFFSET_COMMIT: "OffsetCommit",
    API_OFFSET_FETCH: "OffsetFetch",
    API_FIND_COORDINATOR: "FindCoordinator",
    API_JOIN_GROUP: "JoinGroup",
    API_HEARTBEAT: "Heartbeat",
    API_LEAVE_GROUP: "LeaveGroup",
    API_SYNC_GROUP: "SyncGroup",
    API_VERSIONS: "ApiVersions",
    API_CREATE_TOPICS: "CreateTopics",
    API_DELETE_TOPICS: "DeleteTopics",
}

ERR_NONE = 0
ERR_OFFSET_OUT_OF_RANGE = 1
ERR_UNKNOWN_TOPIC_OR_PARTITION = 3
ERR_COORDINATOR_NOT_AVAILABLE = 15
ERR_ILLEGAL_GENERATION = 22
ERR_UNKNOWN_MEMBER_ID = 25
ERR_REBALANCE_IN_PROGRESS = 27
ERR_UNSUPPORTED_VERSION = 35
ERR_TOPIC_ALREADY_EXISTS = 36
ERR_INVALID_PARTITIONS = 37
ERR_INVALID_REQUEST = 42
ERR_GROUP_ID_NOT_FOUND = 69

ERROR_NAMES = {
    ERR_NONE: "NONE",
    ERR_OFFSET_OUT_OF_RANGE: "OFFSET_OUT_OF_RANGE",
    ERR_UNKNOWN_TOPIC_OR_PARTITION: "UNKNOWN_TOPIC_OR_PARTITION",
    ERR_COORDINATOR_NOT_AVAILABLE: "COORDINATOR_NOT_AVAILABLE",
    ERR_ILLEGAL_GENERATION: "ILLEGAL_GENERATION",
    ERR_UNKNOWN_MEMBER_ID: "UNKNOWN_MEMBER_ID",
    ERR_REBALANCE_IN_PROGRESS: "REBALANCE_IN_PROGRESS",
    ERR_UNSUPPORTED_VERSION: "UNSUPPORTED_VERSION",
    ERR_TOPIC_ALREADY_EXISTS: "TOPIC_ALREADY_EXISTS",
    ERR_INVALID_PARTITIONS: "INVALID_PARTITIONS",
    ERR_INVALID_REQUEST: "INVALID_REQUEST",
    ERR_GROUP_ID_NOT_FOUND: "GROUP_ID_NOT_FOUND",
}


def is_flexible(api: int, version: int) -> bool:
    meta = SUPPORTED_APIS.get(api)
    return meta is not None and meta[2] is not None and version >= meta[2]


# ---------------------------------------------------------------------------
# the protocol engine


class KafkaWire:
    """Parse one Kafka request frame, apply it to the broker, encode the
    response frame. Pure: the only ambient input is ``clock_ms``, read
    exactly once per frame (which is what makes the replay of a recorded
    transcript a byte-identity check)."""

    def __init__(
        self,
        broker: Optional[Broker] = None,
        clock_ms: Callable[[], int] = lambda: 0,
        advertised: Tuple[str, int] = ("127.0.0.1", 9092),
        telemetry=None,
    ):
        self.broker = broker or Broker()
        self.clock_ms = clock_ms
        self.advertised = advertised
        self.telemetry = telemetry  # obs.Telemetry or None (frames/s,
        # per-API latency — wall-clock side, never in a response byte)
        self._now = 0  # per-frame clock sample
        #: (group, member) -> (protocol_name, metadata bytes) for the
        #: JoinGroup member-metadata echo the classic protocol shape needs
        self._member_meta: Dict[Tuple[str, str], Tuple[str, bytes]] = {}
        #: optional transcript sink: (request_frame, clock_ms, response|None)
        self.recorder: Optional[List[Tuple[bytes, int, Optional[bytes]]]] = None

    # -- entry point --------------------------------------------------------

    def handle_frame(self, frame: bytes) -> Optional[bytes]:
        """Request frame body (no length prefix) -> response frame body,
        or ``None`` when the protocol says not to respond (acks=0
        Produce). Raises :class:`WireError` on frames this server cannot
        serve in kind — the transport drops the connection, as a real
        broker does."""
        if self.telemetry is None:
            return self._handle_frame(frame)
        import time as _walltime

        t0 = _walltime.perf_counter()
        api = (
            int.from_bytes(frame[:2], "big", signed=True)
            if len(frame) >= 2
            else -1
        )
        name = API_NAMES.get(api, str(api))
        try:
            return self._handle_frame(frame)
        finally:
            self.telemetry.count(
                "kafka_frames_total", help="request frames served",
                api=name,
            )
            self.telemetry.observe(
                "kafka_api_seconds", _walltime.perf_counter() - t0,
                help="per-API handling latency", api=name,
            )

    def _handle_frame(self, frame: bytes) -> Optional[bytes]:
        r = Reader(frame)
        api = r.i16()
        version = r.i16()
        corr = r.i32()
        self._now = int(self.clock_ms())
        meta = SUPPORTED_APIS.get(api)
        if meta is None:
            raise WireError(f"unsupported api key {api}")
        lo, hi, _flex = meta
        if not lo <= version <= hi:
            if api == API_VERSIONS:
                # KIP-511: answer an unknown ApiVersions version with the
                # v0 body + UNSUPPORTED_VERSION so the client can downshift
                rsp = Writer().i32(corr)
                self._api_versions_body(rsp, 0, ERR_UNSUPPORTED_VERSION)
                out = rsp.done()
                self._record(frame, out)
                return out
            raise WireError(
                f"api {api} v{version} outside the served range {lo}-{hi}"
            )
        flexible = is_flexible(api, version)
        r.nullable_string()  # client_id (request header v1+: every served API)
        if flexible:
            r.tagged_fields()  # header v2 adds tagged fields

        w = Writer()
        w.i32(corr)
        # response header v1 carries tagged fields — except ApiVersions,
        # whose response header is pinned at v0 forever (KIP-511)
        if flexible and api != API_VERSIONS:
            w.tagged_fields()
        body = self._HANDLERS[api](self, r, version, w)
        if body is None:
            self._record(frame, None)
            return None
        out = w.done()
        self._record(frame, out)
        return out

    def _record(self, frame: bytes, rsp: Optional[bytes]) -> None:
        if self.recorder is not None:
            self.recorder.append((bytes(frame), self._now, rsp))

    # -- ApiVersions --------------------------------------------------------

    def _api_versions_body(self, w: Writer, version: int, error: int) -> None:
        flex = version >= 3
        keys = sorted(SUPPORTED_APIS)
        w.i16(error)

        def one(ww: Writer, k: int) -> None:
            lo, hi, _f = SUPPORTED_APIS[k]
            ww.i16(k).i16(lo).i16(hi)
            if flex:
                ww.tagged_fields()

        warr(w, keys, one, flex)
        if version >= 1:
            w.i32(0)  # throttle_time_ms
        if flex:
            w.tagged_fields()

    def _h_api_versions(self, r: Reader, version: int, w: Writer):
        if version >= 3:
            r.compact_string()  # client_software_name
            r.compact_string()  # client_software_version
            r.tagged_fields()
        self._api_versions_body(w, version, ERR_NONE)
        return w

    # -- Metadata -----------------------------------------------------------

    def _h_metadata(self, r: Reader, version: int, w: Writer):
        topics = r.array(r.string)
        if version >= 4:
            r.boolean()  # allow_auto_topic_creation — no auto-create here
        if version == 0 and topics == []:
            topics = None  # v0: empty array = all topics
        all_topics = self.broker.metadata()
        if topics is None:
            wanted = sorted(all_topics)
        else:
            wanted = list(topics)

        if version >= 3:
            w.i32(0)  # throttle
        host, port = self.advertised

        def one_broker(ww: Writer, _b) -> None:
            ww.i32(0).string(host).i32(int(port))
            if version >= 1:
                ww.nullable_string(None)  # rack

        w.array([0], one_broker)
        if version >= 2:
            w.nullable_string("madsim-kafka")  # cluster_id
        if version >= 1:
            w.i32(0)  # controller_id

        def one_topic(ww: Writer, name: str) -> None:
            n = all_topics.get(name)
            ww.i16(ERR_NONE if n is not None else ERR_UNKNOWN_TOPIC_OR_PARTITION)
            ww.string(name)
            if version >= 1:
                ww.boolean(False)  # is_internal

            def one_part(www: Writer, p: int) -> None:
                www.i16(ERR_NONE).i32(p).i32(0)  # error, index, leader
                www.array([0], lambda w4, rep: w4.i32(rep))  # replicas
                www.array([0], lambda w4, rep: w4.i32(rep))  # isr
                if version >= 5:
                    www.array([], lambda w4, rep: w4.i32(rep))  # offline

            ww.array(list(range(n or 0)), one_part)

        w.array(wanted, one_topic)
        return w

    # -- Produce ------------------------------------------------------------

    def _h_produce(self, r: Reader, version: int, w: Writer):
        r.nullable_string()  # transactional_id (v3+ — served span starts at 3)
        acks = r.i16()
        r.i32()  # timeout_ms

        def one_partition() -> Tuple[int, Optional[bytes]]:
            return r.i32(), r.nullable_bytes()

        def one_topic() -> Tuple[str, list]:
            return r.string(), r.array(one_partition) or []

        topics = r.array(one_topic) or []

        results: List[Tuple[str, List[Tuple[int, int, int, int]]]] = []
        for name, parts in topics:
            out_parts = []
            for index, records in parts:
                err, base_off, log_start = ERR_NONE, -1, 0
                try:
                    rows = decode_record_batches(records or b"")
                    first = None
                    for _off, ts, key, val in rows:
                        _p, off = self.broker.produce(
                            name, index, key, val,
                            ts if ts >= 0 else self._now,
                        )
                        if first is None:
                            first = off
                    base_off = first if first is not None else -1
                    log_start = self.broker.watermarks(name, index).low
                except KafkaBrokerError:
                    err = ERR_UNKNOWN_TOPIC_OR_PARTITION
                out_parts.append((index, err, base_off, log_start))
            results.append((name, out_parts))

        if acks == 0:
            return None  # the protocol: fire-and-forget gets no response

        def w_part(ww: Writer, part) -> None:
            index, err, base_off, log_start = part
            ww.i32(index).i16(err).i64(base_off)
            if version >= 2:
                ww.i64(-1)  # log_append_time (CREATE_TIME batches)
            if version >= 5:
                ww.i64(log_start)

        def w_topic(ww: Writer, item) -> None:
            name, parts = item
            ww.string(name)
            ww.array(parts, w_part)

        w.array(results, w_topic)
        w.i32(0)  # throttle (v1+; served span starts at 3)
        return w

    # -- Fetch --------------------------------------------------------------

    def _h_fetch(self, r: Reader, version: int, w: Writer):
        r.i32()  # replica_id
        r.i32()  # max_wait_ms — answered immediately (scope note)
        r.i32()  # min_bytes
        max_bytes = r.i32()  # v3+ (served span starts at 4)
        if version >= 4:
            r.i8()  # isolation_level
        if version >= 7:
            r.i32()  # session_id
            r.i32()  # session_epoch

        def one_partition() -> Tuple[int, int, int]:
            index = r.i32()
            if version >= 9:
                r.i32()  # current_leader_epoch
            fetch_offset = r.i64()
            if version >= 5:
                r.i64()  # log_start_offset (follower fetches)
            return index, fetch_offset, r.i32()  # partition_max_bytes

        def one_topic() -> Tuple[str, list]:
            return r.string(), r.array(one_partition) or []

        topics = r.array(one_topic) or []
        if version >= 7:
            r.array(lambda: (r.string(), r.array(r.i32)))  # forgotten topics

        w.i32(0)  # throttle (v1+)
        if version >= 7:
            w.i16(ERR_NONE)  # top-level error
            w.i32(0)  # session_id

        def w_topic(ww: Writer, item) -> None:
            name, parts = item
            ww.string(name)

            def w_part(www: Writer, part) -> None:
                index, offset, part_max = part
                err, high, low, batch = ERR_NONE, 0, 0, b""
                try:
                    wm = self.broker.watermarks(name, index)
                    high, low = wm.high, wm.low
                    msgs = self.broker.fetch(
                        name, index, offset, max_bytes, part_max
                    )
                    if msgs:
                        batch = encode_record_batch(
                            msgs[0].offset,
                            [(m.timestamp_ms, m.key, m.payload) for m in msgs],
                        )
                except KafkaBrokerError:
                    err = ERR_UNKNOWN_TOPIC_OR_PARTITION
                www.i32(index).i16(err).i64(high)
                www.i64(high)  # last_stable_offset (v4+; no transactions)
                if version >= 5:
                    www.i64(low)  # log_start_offset
                www.array([], lambda w4, _a: None)  # aborted_transactions
                if version >= 11:
                    www.i32(-1)  # preferred_read_replica
                www.nullable_bytes(batch)

            ww.array(parts, w_part)

        w.array(topics, w_topic)
        return w

    # -- ListOffsets ---------------------------------------------------------

    def _h_list_offsets(self, r: Reader, version: int, w: Writer):
        r.i32()  # replica_id
        if version >= 2:
            r.i8()  # isolation_level

        def one_partition() -> Tuple[int, int]:
            index = r.i32()
            if version >= 4:
                r.i32()  # current_leader_epoch
            return index, r.i64()

        def one_topic() -> Tuple[str, list]:
            return r.string(), r.array(one_partition) or []

        topics = r.array(one_topic) or []
        if version >= 2:
            w.i32(0)  # throttle

        def w_topic(ww: Writer, item) -> None:
            name, parts = item
            ww.string(name)

            def w_part(www: Writer, part) -> None:
                index, ts = part
                err, out_ts, out_off = ERR_NONE, -1, -1
                try:
                    wm = self.broker.watermarks(name, index)
                    if ts == -1:  # latest
                        out_off = wm.high
                    elif ts == -2:  # earliest
                        out_off = wm.low
                    else:
                        (_t, _p, found), = self.broker.offsets_for_times(
                            [(name, index, ts)]
                        )
                        if found is not None:
                            out_off = found
                            part_obj = self.broker._partition(name, index)
                            out_ts = part_obj.log[
                                found - part_obj.base_offset
                            ].timestamp_ms
                except KafkaBrokerError:
                    err = ERR_UNKNOWN_TOPIC_OR_PARTITION
                www.i32(index).i16(err).i64(out_ts).i64(out_off)
                if version >= 4:
                    www.i32(-1)  # leader_epoch

            ww.array(parts, w_part)

        w.array(topics, w_topic)
        return w

    # -- FindCoordinator ------------------------------------------------------

    def _h_find_coordinator(self, r: Reader, version: int, w: Writer):
        flex = is_flexible(API_FIND_COORDINATOR, version)
        rstr(r, flex)  # key (the group id)
        if version >= 1:
            r.i8()  # key_type — groups and txn ids both land here
        if flex:
            r.tagged_fields()
        host, port = self.advertised
        if version >= 1:
            w.i32(0)  # throttle
        w.i16(ERR_NONE)
        if version >= 1:
            wnstr(w, None, flex)  # error_message
        w.i32(0)  # node_id
        wstr(w, host, flex)
        w.i32(int(port))
        if flex:
            w.tagged_fields()
        return w

    # -- group membership -----------------------------------------------------

    def _h_join_group(self, r: Reader, version: int, w: Writer):
        group = r.string()
        r.i32()  # session_timeout_ms
        if version >= 1:
            r.i32()  # rebalance_timeout_ms
        member_id = r.string()
        if version >= 5:
            r.nullable_string()  # group_instance_id
        protocol_type = r.string()
        protocols = r.array(lambda: (r.string(), r.bytes32())) or []

        err, gen, proto_name, leader, out_member = ERR_NONE, -1, "", "", member_id
        if protocol_type not in ("", "consumer") or not protocols:
            err = ERR_INVALID_REQUEST
        else:
            proto_name, meta_blob = protocols[0]
            try:
                topics = decode_subscription(meta_blob)
                out_member, gen, _assigned = self.broker.join_group(
                    group, member_id or None, topics
                )
                self._member_meta[(group, out_member)] = (proto_name, meta_blob)
                g = self.broker.groups[group]
                leader = next(iter(g.members))
            except KafkaBrokerError:
                err = ERR_UNKNOWN_TOPIC_OR_PARTITION
            except WireError:
                err = ERR_INVALID_REQUEST

        if version >= 2:
            w.i32(0)  # throttle
        w.i16(err).i32(gen).string(proto_name).string(leader).string(out_member)

        members: List[Tuple[str, bytes]] = []
        if err == ERR_NONE and out_member == leader:
            g = self.broker.groups[group]
            members = [
                (m, self._member_meta.get((group, m), ("", b""))[1])
                for m in g.members
            ]

        def w_member(ww: Writer, item) -> None:
            mid, blob = item
            ww.string(mid)
            if version >= 5:
                ww.nullable_string(None)  # group_instance_id
            ww.bytes32(blob)

        w.array(members, w_member)
        return w

    def _group_errcheck(self, group: str, member: str, generation: int) -> int:
        """The shared coordinator fence: unknown group/member, then a
        stale generation (the rejoin signal)."""
        g = self.broker.groups.get(group)
        if g is None:
            return ERR_GROUP_ID_NOT_FOUND
        if member not in g.members:
            return ERR_UNKNOWN_MEMBER_ID
        if generation != g.generation:
            return ERR_REBALANCE_IN_PROGRESS
        return ERR_NONE

    def _h_sync_group(self, r: Reader, version: int, w: Writer):
        group = r.string()
        generation = r.i32()
        member = r.string()
        if version >= 3:
            r.nullable_string()  # group_instance_id
        # leader-computed assignments: parsed, then deliberately ignored —
        # the broker's own deterministic range assignor answers (docstring)
        r.array(lambda: (r.string(), r.bytes32()))

        err = self._group_errcheck(group, member, generation)
        blob = b""
        if err == ERR_NONE:
            _gen, assigned = self.broker.group_state(group, member)
            blob = encode_assignment(assigned)
        if version >= 1:
            w.i32(0)  # throttle
        w.i16(err).bytes32(blob)
        return w

    def _h_heartbeat(self, r: Reader, version: int, w: Writer):
        flex = is_flexible(API_HEARTBEAT, version)
        group = rstr(r, flex)
        generation = r.i32()
        member = rstr(r, flex)
        if version >= 3:
            rnstr(r, flex)  # group_instance_id
        if flex:
            r.tagged_fields()
        err = self._group_errcheck(group, member, generation)
        if version >= 1:
            w.i32(0)  # throttle
        w.i16(err)
        if flex:
            w.tagged_fields()
        return w

    def _h_leave_group(self, r: Reader, version: int, w: Writer):
        group = r.string()
        if version >= 3:
            members = [
                m for m, _inst in
                (r.array(lambda: (r.string(), r.nullable_string())) or [])
            ]
        else:
            members = [r.string()]

        results: List[Tuple[str, int]] = []
        for m in members:
            try:
                self.broker.leave_group(group, m)
                self._member_meta.pop((group, m), None)
                results.append((m, ERR_NONE))
            except KafkaBrokerError:
                results.append((m, ERR_GROUP_ID_NOT_FOUND))

        if version >= 1:
            w.i32(0)  # throttle
        w.i16(ERR_NONE if all(e == ERR_NONE for _m, e in results)
              else results[0][1])
        if version >= 3:
            def w_member(ww: Writer, item) -> None:
                mid, err = item
                ww.string(mid).nullable_string(None).i16(err)

            w.array(results, w_member)
        return w

    # -- offsets ---------------------------------------------------------------

    def _h_offset_commit(self, r: Reader, version: int, w: Writer):
        group = r.string()
        generation = r.i32()
        r.string()  # member_id (the generation fence is the commit guard)
        if 2 <= version <= 4:
            r.i64()  # retention_time_ms

        def one_partition() -> Tuple[int, int]:
            index = r.i32()
            offset = r.i64()
            r.nullable_string()  # metadata
            return index, offset

        def one_topic() -> Tuple[str, list]:
            return r.string(), r.array(one_partition) or []

        topics = r.array(one_topic) or []

        # generation -1 = a groupless/simple committer: skip the zombie
        # fence, exactly like the legacy tuple protocol's 3-tuple commit
        fence: Optional[int] = None if generation < 0 else generation
        results: List[Tuple[str, List[Tuple[int, int]]]] = []
        for name, parts in topics:
            out_parts = []
            for index, offset in parts:
                try:
                    self.broker.commit_offsets(
                        group, [(name, index, offset)], fence
                    )
                    out_parts.append((index, ERR_NONE))
                except KafkaBrokerError as e:
                    msg = str(e)
                    if "ILLEGAL_GENERATION" in msg:
                        code = ERR_ILLEGAL_GENERATION
                    elif "unknown group" in msg:
                        code = ERR_GROUP_ID_NOT_FOUND
                    else:
                        code = ERR_UNKNOWN_TOPIC_OR_PARTITION
                    out_parts.append((index, code))
            results.append((name, out_parts))

        if version >= 3:
            w.i32(0)  # throttle

        def w_topic(ww: Writer, item) -> None:
            name, parts = item
            ww.string(name)
            ww.array(parts, lambda www, p: www.i32(p[0]).i16(p[1]))

        w.array(results, w_topic)
        return w

    def _h_offset_fetch(self, r: Reader, version: int, w: Writer):
        group = r.string()
        topics = r.array(lambda: (r.string(), r.array(r.i32) or []))

        g = self.broker.groups.get(group)
        if topics is None:
            # null topics (v2+): every partition the group has committed
            by_topic: Dict[str, List[int]] = {}
            if g is not None:
                for (t, p) in sorted(g.committed):
                    by_topic.setdefault(t, []).append(p)
            topics = sorted(by_topic.items())

        if version >= 3:
            w.i32(0)  # throttle

        def w_topic(ww: Writer, item) -> None:
            name, parts = item
            ww.string(name)

            def w_part(www: Writer, index: int) -> None:
                off = -1
                if g is not None:
                    off = g.committed.get((name, index), -1)
                    if off is None:
                        off = -1
                www.i32(index).i64(off)
                if version >= 5:
                    www.i32(-1)  # leader_epoch
                www.nullable_string(None)  # metadata
                www.i16(ERR_NONE)

            ww.array(parts, w_part)

        w.array(topics, w_topic)
        if version >= 2:
            w.i16(ERR_NONE)  # top-level error
        return w

    # -- topic admin -----------------------------------------------------------

    def _h_create_topics(self, r: Reader, version: int, w: Writer):
        def one_topic():
            name = r.string()
            num_partitions = r.i32()
            r.i16()  # replication_factor
            r.array(lambda: (r.i32(), r.array(r.i32)))  # manual assignments
            r.array(lambda: (r.string(), r.nullable_string()))  # configs
            return name, num_partitions

        topics = r.array(one_topic) or []
        r.i32()  # timeout_ms
        validate_only = r.boolean() if version >= 1 else False

        results: List[Tuple[str, int, Optional[str]]] = []
        for name, num_partitions in topics:
            if num_partitions < 0:
                num_partitions = 1  # -1 = broker default
            try:
                if validate_only:
                    if name in self.broker.topics:
                        raise KafkaBrokerError(f"topic already exists: {name!r}")
                    if num_partitions <= 0:
                        raise KafkaBrokerError("num_partitions must be positive")
                else:
                    self.broker.create_topic(name, num_partitions)
                results.append((name, ERR_NONE, None))
            except KafkaBrokerError as e:
                code = (ERR_TOPIC_ALREADY_EXISTS if "already exists" in str(e)
                        else ERR_INVALID_PARTITIONS)
                results.append((name, code, str(e)))

        if version >= 2:
            w.i32(0)  # throttle

        def w_topic(ww: Writer, item) -> None:
            name, err, msg = item
            ww.string(name).i16(err)
            if version >= 1:
                ww.nullable_string(msg)

        w.array(results, w_topic)
        return w

    def _h_delete_topics(self, r: Reader, version: int, w: Writer):
        names = r.array(r.string) or []
        r.i32()  # timeout_ms
        results = []
        for name in names:
            try:
                self.broker.delete_topic(name)
                results.append((name, ERR_NONE))
            except KafkaBrokerError:
                results.append((name, ERR_UNKNOWN_TOPIC_OR_PARTITION))
        if version >= 1:
            w.i32(0)  # throttle
        w.array(results, lambda ww, it: ww.string(it[0]).i16(it[1]))
        return w

    _HANDLERS = {
        API_PRODUCE: _h_produce,
        API_FETCH: _h_fetch,
        API_LIST_OFFSETS: _h_list_offsets,
        API_METADATA: _h_metadata,
        API_OFFSET_COMMIT: _h_offset_commit,
        API_OFFSET_FETCH: _h_offset_fetch,
        API_FIND_COORDINATOR: _h_find_coordinator,
        API_JOIN_GROUP: _h_join_group,
        API_HEARTBEAT: _h_heartbeat,
        API_LEAVE_GROUP: _h_leave_group,
        API_SYNC_GROUP: _h_sync_group,
        API_VERSIONS: _h_api_versions,
        API_CREATE_TOPICS: _h_create_topics,
        API_DELETE_TOPICS: _h_delete_topics,
    }


# ---------------------------------------------------------------------------
# framing


class FrameBuffer:
    """Reassemble 4-byte length-prefixed frames from arbitrary byte
    chunks — one parser for both tiers (sim pipes may deliver a frame
    whole; TCP may split it anywhere)."""

    MAX_FRAME = 64 * 1024 * 1024

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, chunk: bytes) -> List[bytes]:
        self._buf += chunk
        out: List[bytes] = []
        while len(self._buf) >= 4:
            (n,) = _I32.unpack(self._buf[:4])
            if not 0 <= n <= self.MAX_FRAME:
                raise WireError(f"insane frame length {n}")
            if len(self._buf) < 4 + n:
                break
            out.append(bytes(self._buf[4:4 + n]))
            del self._buf[:4 + n]
        return out


def frame(body: bytes) -> bytes:
    """Length-prefix one wire frame (Kafka's framing is exactly the
    repo-wide 4-byte big-endian convention of ``real/stream.py``)."""
    return _I32.pack(len(body)) + body


# ---------------------------------------------------------------------------
# sim-tier serving: the Endpoint / connect1 pipe plumbing


class SimWireServer:
    """Serve the genuine Kafka wire inside the simulator: ``accept1``
    connections whose pipes carry raw byte chunks (framed by
    :func:`frame`), one conn task per client, virtual-clock timestamps.
    The sim twin of :class:`WireServer`, mirroring how ``kafka/server.py``
    and ``real/kafka.py`` split the legacy dispatcher."""

    def __init__(self, broker: Optional[Broker] = None, telemetry=None):
        self.broker = broker or Broker()
        self.telemetry = telemetry
        self.wire: Optional[KafkaWire] = None
        self.bound_addr: Optional[Tuple[str, int]] = None

    @staticmethod
    def _now_ms() -> int:
        from ..context import current_handle

        return current_handle().time.now_time_ns() // 1_000_000

    async def serve(self, addr: "str | tuple") -> None:
        from .. import task as mstask
        from ..net.endpoint import Endpoint

        ep = await Endpoint.bind(addr)
        self.bound_addr = ep.local_addr()
        self.wire = KafkaWire(
            self.broker, self._now_ms, self.bound_addr,
            telemetry=self.telemetry,
        )
        while True:
            tx, rx, _src = await ep.accept1()
            mstask.spawn(self._serve_conn(tx, rx), name="kafka-wire-conn")

    async def _serve_conn(self, tx: Any, rx: Any) -> None:
        buf = FrameBuffer()
        if self.telemetry is not None:
            self.telemetry.count(
                "kafka_connections_total", help="accepted connections"
            )
        try:
            while True:
                chunk = await rx.recv()
                if chunk is None:
                    return
                for req in buf.feed(chunk):
                    rsp = self.wire.handle_frame(req)
                    if rsp is not None:
                        await tx.send(frame(rsp))
        except (WireError, KeyError, ValueError, struct.error):
            rx.close()  # protocol violation: hard-drop, like a real broker
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            tx.close()


# ---------------------------------------------------------------------------
# real-tier serving: raw TCP via asyncio streams


class WireServer:
    """Serve the genuine Kafka wire on a real TCP port (wall-clock
    timestamps) — what ``real.kafka.SimBroker.serve`` now runs by
    default, and what a stock client connects to.

    The accept loop, framing, backpressure, and lifecycle metrics live
    in the shared serving core (``madsim_tpu_torch/serve/``); this class is
    the thin Kafka adapter over it: ``KafkaWire.handle_frame`` stays a
    pure function of (request bytes, clock), so the live-vs-replay
    byte-identity gate holds through the core unchanged.
    ``clock_ms=`` injects a deterministic clock (the determinism leg);
    ``shards=`` spreads accepts over N SO_REUSEPORT loops.
    """

    def __init__(self, broker: Optional[Broker] = None, telemetry=None,
                 clock_ms: Optional[Callable[[], int]] = None,
                 shards: int = 1,
                 advertised: Optional[Tuple[str, int]] = None):
        self.broker = broker or Broker()
        self.telemetry = telemetry
        self.wire: Optional[KafkaWire] = None
        self.bound_addr: Optional[Tuple[str, int]] = None
        self._clock_ms = clock_ms
        self._shards = shards
        self._core = None
        # determinism legs pin this: Metadata/FindCoordinator responses
        # embed the advertised address, and an ephemeral bound port
        # would leak into the transcript hash
        self._advertised = advertised

    @staticmethod
    def _now_ms() -> int:
        import time as _walltime

        return _walltime.time_ns() // 1_000_000

    def _count_conn(self, _conn) -> None:
        if self.telemetry is not None:
            self.telemetry.count(
                "kafka_connections_total", help="accepted connections"
            )

    async def start(self, addr: "str | tuple") -> None:
        from ..serve import AsyncWireServer, PureFrameAdapter

        adapter = PureFrameAdapter(
            self._handle, name="kafka",
            drop_errors=(WireError, KeyError, ValueError, struct.error),
            connect_hook=self._count_conn,
        )
        self._core = AsyncWireServer(
            adapter, telemetry=self.telemetry, shards=self._shards
        )
        self.bound_addr = await self._core.start(addr)
        self.wire = KafkaWire(
            self.broker, self._clock_ms or self._now_ms,
            self._advertised or self.bound_addr,
            telemetry=self.telemetry,
        )

    def _handle(self, req: bytes) -> Optional[bytes]:
        return self.wire.handle_frame(req)

    async def serve(self, addr: "str | tuple") -> None:
        await self.start(addr)
        try:
            await self._core._stopped.wait()
        finally:
            self._core._teardown()

    def close(self) -> None:
        if self._core is not None:
            self._core.close()

    async def aclose(self, drain_timeout: float = 5.0) -> None:
        """Graceful drain — in-flight frames answered, queues flushed."""
        if self._core is not None:
            await self._core.aclose(drain_timeout)


class LegacyWireServer:
    """The pre-core thread-of-control per connection server (one
    asyncio streams task per conn, unbounded write buffering). Kept as
    the A/B baseline for the determinism and parity gates; deprecated
    for serving — see docs/wire.md."""

    def __init__(self, broker: Optional[Broker] = None, telemetry=None,
                 clock_ms: Optional[Callable[[], int]] = None,
                 advertised: Optional[Tuple[str, int]] = None):
        self.broker = broker or Broker()
        self.telemetry = telemetry
        self.wire: Optional[KafkaWire] = None
        self.bound_addr: Optional[Tuple[str, int]] = None
        self._clock_ms = clock_ms
        self._server = None
        self._advertised = advertised

    @staticmethod
    def _now_ms() -> int:
        import time as _walltime

        return _walltime.time_ns() // 1_000_000

    async def start(self, addr: "str | tuple") -> None:
        import asyncio

        from ..real.stream import parse_addr

        host, port = parse_addr(addr)
        self._server = await asyncio.start_server(self._conn, host, port)
        self.bound_addr = self._server.sockets[0].getsockname()[:2]
        self.wire = KafkaWire(
            self.broker, self._clock_ms or self._now_ms,
            self._advertised or self.bound_addr,
            telemetry=self.telemetry,
        )

    async def serve(self, addr: "str | tuple") -> None:
        await self.start(addr)
        async with self._server:
            await self._server.serve_forever()

    def close(self) -> None:
        if self._server is not None:
            self._server.close()

    async def _conn(self, reader, writer) -> None:
        from ..real.stream import read_frame_raw, write_frame_raw

        if self.telemetry is not None:
            self.telemetry.count(
                "kafka_connections_total", help="accepted connections"
            )
        try:
            while True:
                req = await read_frame_raw(reader)
                if req is None:
                    return
                rsp = self.wire.handle_frame(req)
                if rsp is not None:
                    await write_frame_raw(writer, rsp)
        except (WireError, KeyError, ValueError, struct.error,
                ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass
