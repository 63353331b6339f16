"""A minimal vendored Kafka wire client ("probe"): enough of the binary
protocol to exercise every API ``kafka/wire.py`` serves, from either
tier.

No kafka-python/librdkafka ships in this image, so the stock-client
round-trip story is held by this probe instead: it speaks the genuine
frame/header/record-batch-v2 encodings (sharing the primitive codec with
the server — the compositions are written independently per API, which
is the same stance the etcd wire tests take with shared protobuf message
classes), negotiates versions via ApiVersions, and raises on every
non-zero error code unless the caller asked for the raw code.

Transports: :class:`RealTransport` dials real TCP (asyncio);
:class:`SimTransport` dials the simulator's ``connect1`` pipes carrying
framed byte chunks; :class:`LoopbackTransport` feeds a ``KafkaWire``
in-process — the pure-codec path the differential fuzz and the
determinism gate lean on.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .wire import (
    API_CREATE_TOPICS,
    API_DELETE_TOPICS,
    API_FETCH,
    API_FIND_COORDINATOR,
    API_HEARTBEAT,
    API_JOIN_GROUP,
    API_LEAVE_GROUP,
    API_LIST_OFFSETS,
    API_METADATA,
    API_OFFSET_COMMIT,
    API_OFFSET_FETCH,
    API_PRODUCE,
    API_SYNC_GROUP,
    API_VERSIONS,
    ERROR_NAMES,
    FrameBuffer,
    KafkaWire,
    Reader,
    Record,
    Writer,
    decode_assignment,
    decode_record_batches,
    encode_record_batch,
    encode_subscription,
    frame,
    is_flexible,
    rnstr,
    rstr,
)


class ProbeError(Exception):
    """A non-zero Kafka error code surfaced by the probe."""

    def __init__(self, code: int, where: str):
        self.code = code
        super().__init__(
            f"{where}: {ERROR_NAMES.get(code, 'error')} ({code})"
        )


def _check(code: int, where: str) -> None:
    if code != 0:
        raise ProbeError(code, where)


# ---------------------------------------------------------------------------
# transports


class RealTransport:
    """One persistent TCP connection (asyncio streams)."""

    def __init__(self, reader, writer):
        self._reader = reader
        self._writer = writer

    @classmethod
    async def connect(cls, addr: "str | tuple") -> "RealTransport":
        import asyncio

        from ..real.stream import parse_addr

        host, port = parse_addr(addr)
        reader, writer = await asyncio.open_connection(host, port)
        return cls(reader, writer)

    async def send_frame(self, body: bytes) -> None:
        from ..real.stream import write_frame_raw

        await write_frame_raw(self._writer, body)

    async def recv_frame(self) -> Optional[bytes]:
        from ..real.stream import read_frame_raw

        return await read_frame_raw(self._reader)

    def close(self) -> None:
        try:
            self._writer.close()
        except Exception:
            pass


class SimTransport:
    """One persistent sim connection: ``connect1`` pipes carrying framed
    byte chunks (the Endpoint/stream plumbing of the sim tier)."""

    def __init__(self, tx, rx):
        self._tx = tx
        self._rx = rx
        self._buf = FrameBuffer()
        self._ready: List[bytes] = []

    @classmethod
    async def connect(cls, addr: "str | tuple") -> "SimTransport":
        from ..net.endpoint import connect1_ephemeral

        tx, rx = await connect1_ephemeral(addr)
        return cls(tx, rx)

    async def send_frame(self, body: bytes) -> None:
        await self._tx.send(frame(body))

    async def recv_frame(self) -> Optional[bytes]:
        while not self._ready:
            chunk = await self._rx.recv()
            if chunk is None:
                return None
            self._ready.extend(self._buf.feed(chunk))
        return self._ready.pop(0)

    def close(self) -> None:
        self._tx.close()
        self._rx.close()


class LoopbackTransport:
    """Feed a :class:`KafkaWire` directly — no sockets, pure codec. The
    differential-fuzz workhorse: every byte still round-trips through
    the full request/response encodings."""

    def __init__(self, wire: KafkaWire):
        self.wire = wire
        self._ready: List[bytes] = []

    async def send_frame(self, body: bytes) -> None:
        rsp = self.wire.handle_frame(body)
        if rsp is not None:
            self._ready.append(rsp)

    async def recv_frame(self) -> Optional[bytes]:
        if not self._ready:
            raise ProbeError(-1, "loopback: no response pending")
        return self._ready.pop(0)

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# the probe client


class ProbeClient:
    """The vendored wire client. Methods take an explicit ``ver`` so the
    fuzz can sweep the advertised version matrix; defaults are sensible
    mid-range picks."""

    def __init__(self, transport, client_id: str = "madsim-probe"):
        self.t = transport
        self.client_id = client_id
        self._corr = 0

    def close(self) -> None:
        self.t.close()

    # -- plumbing -----------------------------------------------------------

    def _header(self, api: int, ver: int) -> Writer:
        self._corr += 1
        w = Writer()
        w.i16(api).i16(ver).i32(self._corr)
        w.nullable_string(self.client_id)
        if is_flexible(api, ver):
            w.tagged_fields()
        return w

    async def _call(self, api: int, ver: int, w: Writer,
                    expect_response: bool = True) -> Optional[Reader]:
        await self.t.send_frame(w.done())
        if not expect_response:
            return None
        body = await self.t.recv_frame()
        if body is None:
            raise ProbeError(-1, "connection closed mid-call")
        r = Reader(body)
        corr = r.i32()
        if corr != self._corr:
            raise ProbeError(-1, f"correlation mismatch {corr} != {self._corr}")
        if is_flexible(api, ver) and api != API_VERSIONS:
            r.tagged_fields()
        return r

    # -- ApiVersions ---------------------------------------------------------

    async def api_versions(self, ver: int = 0) -> Tuple[int, Dict[int, Tuple[int, int]]]:
        """Returns (error_code, {api: (min, max)})."""
        w = self._header(API_VERSIONS, ver)
        if ver >= 3:
            w.compact_string("madsim-probe").compact_string("1.0")
            w.tagged_fields()
        r = await self._call(API_VERSIONS, ver, w)
        flex = ver >= 3
        err = r.i16()
        out: Dict[int, Tuple[int, int]] = {}

        def one():
            k, lo, hi = r.i16(), r.i16(), r.i16()
            if flex:
                r.tagged_fields()
            out[k] = (lo, hi)

        (r.compact_array if flex else r.array)(one)
        return err, out

    # -- Metadata ------------------------------------------------------------

    async def metadata(self, topics: Optional[List[str]] = None,
                       ver: int = 1) -> Dict[str, "int | None"]:
        """topic -> partition count (None = topic-level error)."""
        w = self._header(API_METADATA, ver)
        if topics is None:
            w.i32(0 if ver == 0 else -1)
        else:
            w.array(topics, lambda ww, t: ww.string(t))
        if ver >= 4:
            w.boolean(False)
        r = await self._call(API_METADATA, ver, w)
        if ver >= 3:
            r.i32()

        def one_broker():
            r.i32(); r.string(); r.i32()
            if ver >= 1:
                r.nullable_string()

        r.array(one_broker)
        if ver >= 2:
            r.nullable_string()
        if ver >= 1:
            r.i32()
        out: Dict[str, "int | None"] = {}

        def one_topic():
            err = r.i16()
            name = r.string()
            if ver >= 1:
                r.boolean()

            def one_part():
                r.i16(); r.i32(); r.i32()
                r.array(r.i32); r.array(r.i32)
                if ver >= 5:
                    r.array(r.i32)

            parts = r.array(one_part)
            out[name] = len(parts or []) if err == 0 else None

        r.array(one_topic)
        return out

    # -- topic admin ----------------------------------------------------------

    async def create_topics(
        self, topics: List[Tuple[str, int]], ver: int = 1
    ) -> List[Tuple[str, int, Optional[str]]]:
        w = self._header(API_CREATE_TOPICS, ver)

        def one(ww: Writer, item) -> None:
            name, parts = item
            ww.string(name).i32(parts).i16(1)
            ww.array([], lambda w2, _x: None)
            ww.array([], lambda w2, _x: None)

        w.array(topics, one)
        w.i32(30_000)
        if ver >= 1:
            w.boolean(False)
        r = await self._call(API_CREATE_TOPICS, ver, w)
        if ver >= 2:
            r.i32()
        out = []

        def one_rsp():
            name = r.string()
            err = r.i16()
            msg = r.nullable_string() if ver >= 1 else None
            out.append((name, err, msg))

        r.array(one_rsp)
        return out

    async def delete_topics(self, names: List[str],
                            ver: int = 1) -> List[Tuple[str, int]]:
        w = self._header(API_DELETE_TOPICS, ver)
        w.array(names, lambda ww, n: ww.string(n))
        w.i32(30_000)
        r = await self._call(API_DELETE_TOPICS, ver, w)
        if ver >= 1:
            r.i32()
        out = []
        r.array(lambda: out.append((r.string(), r.i16())))
        return out

    # -- Produce / Fetch / ListOffsets ----------------------------------------

    async def produce(self, topic: str, partition: int,
                      records: List[Record], ver: int = 5,
                      acks: int = 1) -> Tuple[int, int]:
        """Returns (error_code, base_offset); acks=0 returns (0, -1)
        without waiting (fire-and-forget, as on the real wire)."""
        w = self._header(API_PRODUCE, ver)
        w.nullable_string(None)  # transactional_id
        w.i16(acks).i32(30_000)
        batch = encode_record_batch(0, records)

        def one_topic(ww: Writer, name: str) -> None:
            ww.string(name)
            ww.array([partition],
                     lambda w2, p: w2.i32(p).nullable_bytes(batch))

        w.array([topic], one_topic)
        r = await self._call(API_PRODUCE, ver, w, expect_response=acks != 0)
        if r is None:
            return 0, -1
        result = [0, -1]

        def one_rsp():
            r.string()

            def one_part():
                r.i32()
                result[0] = r.i16()
                result[1] = r.i64()
                if ver >= 2:
                    r.i64()
                if ver >= 5:
                    r.i64()

            r.array(one_part)

        r.array(one_rsp)
        r.i32()  # throttle
        return result[0], result[1]

    async def fetch(self, topic: str, partition: int, offset: int,
                    max_bytes: int = 52_428_800,
                    partition_max_bytes: int = 1_048_576,
                    ver: int = 4) -> Tuple[int, int, List[Tuple[int, int, Optional[bytes], Optional[bytes]]]]:
        """Returns (error_code, high_watermark, [(offset, ts, key, value)])."""
        w = self._header(API_FETCH, ver)
        w.i32(-1).i32(0).i32(1).i32(max_bytes)
        if ver >= 4:
            w.i8(0)
        if ver >= 7:
            w.i32(0).i32(-1)

        def one_topic(ww: Writer, name: str) -> None:
            ww.string(name)

            def one_part(w2: Writer, p: int) -> None:
                w2.i32(p)
                if ver >= 9:
                    w2.i32(-1)
                w2.i64(offset)
                if ver >= 5:
                    w2.i64(-1)
                w2.i32(partition_max_bytes)

            ww.array([partition], one_part)

        w.array([topic], one_topic)
        if ver >= 7:
            w.array([], lambda ww, _x: None)
        r = await self._call(API_FETCH, ver, w)
        r.i32()  # throttle
        if ver >= 7:
            r.i16(); r.i32()
        result: List[Tuple[int, int, List]] = []

        def one_rsp():
            r.string()

            def one_part():
                r.i32()
                err = r.i16()
                high = r.i64()
                r.i64()  # last_stable_offset
                if ver >= 5:
                    r.i64()  # log_start_offset
                r.array(lambda: (r.i64(), r.i64()))  # aborted txns
                if ver >= 11:
                    r.i32()
                blob = r.nullable_bytes() or b""
                result.append((err, high, decode_record_batches(blob)))

            r.array(one_part)

        r.array(one_rsp)
        err, high, rows = result[0]
        return err, high, rows

    async def list_offsets(self, topic: str, partition: int, ts: int,
                           ver: int = 1) -> Tuple[int, int, int]:
        """Returns (error_code, timestamp, offset); ts -1=latest,
        -2=earliest, else first-offset-with-timestamp>=ts."""
        w = self._header(API_LIST_OFFSETS, ver)
        w.i32(-1)
        if ver >= 2:
            w.i8(0)

        def one_topic(ww: Writer, name: str) -> None:
            ww.string(name)

            def one_part(w2: Writer, p: int) -> None:
                w2.i32(p)
                if ver >= 4:
                    w2.i32(-1)
                w2.i64(ts)

            ww.array([partition], one_part)

        w.array([topic], one_topic)
        r = await self._call(API_LIST_OFFSETS, ver, w)
        if ver >= 2:
            r.i32()
        result = [0, -1, -1]

        def one_rsp():
            r.string()

            def one_part():
                r.i32()
                result[0] = r.i16()
                result[1] = r.i64()
                result[2] = r.i64()
                if ver >= 4:
                    r.i32()

            r.array(one_part)

        r.array(one_rsp)
        return result[0], result[1], result[2]

    # -- group coordination ----------------------------------------------------

    async def find_coordinator(self, group: str,
                               ver: int = 0) -> Tuple[int, str, int]:
        flex = is_flexible(API_FIND_COORDINATOR, ver)
        w = self._header(API_FIND_COORDINATOR, ver)
        (w.compact_string if flex else w.string)(group)
        if ver >= 1:
            w.i8(0)
        if flex:
            w.tagged_fields()
        r = await self._call(API_FIND_COORDINATOR, ver, w)
        if ver >= 1:
            r.i32()
        err = r.i16()
        if ver >= 1:
            rnstr(r, flex)
        r.i32()  # node_id
        host = rstr(r, flex)
        port = r.i32()
        if flex:
            r.tagged_fields()
        return err, host, port

    async def join_group(
        self, group: str, member_id: str, topics: List[str], ver: int = 2
    ) -> Tuple[int, int, str, str, List[Tuple[str, bytes]]]:
        """Returns (error, generation, member_id, leader, members)."""
        w = self._header(API_JOIN_GROUP, ver)
        w.string(group).i32(30_000)
        if ver >= 1:
            w.i32(60_000)
        w.string(member_id)
        if ver >= 5:
            w.nullable_string(None)
        w.string("consumer")
        w.array([("range", encode_subscription(topics))],
                lambda ww, p: ww.string(p[0]).bytes32(p[1]))
        r = await self._call(API_JOIN_GROUP, ver, w)
        if ver >= 2:
            r.i32()
        err = r.i16()
        gen = r.i32()
        r.string()  # protocol_name
        leader = r.string()
        member = r.string()
        members: List[Tuple[str, bytes]] = []

        def one():
            mid = r.string()
            if ver >= 5:
                r.nullable_string()
            members.append((mid, r.bytes32()))

        r.array(one)
        return err, gen, member, leader, members

    async def sync_group(
        self, group: str, generation: int, member: str, ver: int = 1,
        assignments: Optional[List[Tuple[str, bytes]]] = None,
    ) -> Tuple[int, List[Tuple[str, int]]]:
        """Returns (error, [(topic, partition)])."""
        w = self._header(API_SYNC_GROUP, ver)
        w.string(group).i32(generation).string(member)
        if ver >= 3:
            w.nullable_string(None)
        w.array(assignments or [],
                lambda ww, p: ww.string(p[0]).bytes32(p[1]))
        r = await self._call(API_SYNC_GROUP, ver, w)
        if ver >= 1:
            r.i32()
        err = r.i16()
        blob = r.bytes32()
        return err, (decode_assignment(blob) if blob else [])

    async def heartbeat(self, group: str, generation: int, member: str,
                        ver: int = 0) -> int:
        flex = is_flexible(API_HEARTBEAT, ver)
        w = self._header(API_HEARTBEAT, ver)
        (w.compact_string if flex else w.string)(group)
        w.i32(generation)
        (w.compact_string if flex else w.string)(member)
        if ver >= 3:
            (w.compact_nullable_string if flex else w.nullable_string)(None)
        if flex:
            w.tagged_fields()
        r = await self._call(API_HEARTBEAT, ver, w)
        if ver >= 1:
            r.i32()
        return r.i16()

    async def leave_group(self, group: str, member: str, ver: int = 1) -> int:
        w = self._header(API_LEAVE_GROUP, ver)
        w.string(group)
        if ver >= 3:
            w.array([(member, None)],
                    lambda ww, p: ww.string(p[0]).nullable_string(p[1]))
        else:
            w.string(member)
        r = await self._call(API_LEAVE_GROUP, ver, w)
        if ver >= 1:
            r.i32()
        err = r.i16()
        if ver >= 3:
            r.array(lambda: (r.string(), r.nullable_string(), r.i16()))
        return err

    async def offset_commit(
        self, group: str, generation: int, member: str,
        offsets: List[Tuple[str, int, int]], ver: int = 2,
    ) -> List[Tuple[str, int, int]]:
        """Returns [(topic, partition, error_code)]."""
        by_topic: Dict[str, List[Tuple[int, int]]] = {}
        for t, p, o in offsets:
            by_topic.setdefault(t, []).append((p, o))
        w = self._header(API_OFFSET_COMMIT, ver)
        w.string(group).i32(generation).string(member)
        if 2 <= ver <= 4:
            w.i64(-1)  # retention_time_ms

        def one_topic(ww: Writer, item) -> None:
            name, parts = item
            ww.string(name)
            ww.array(parts,
                     lambda w2, p: w2.i32(p[0]).i64(p[1]).nullable_string(None))

        w.array(sorted(by_topic.items()), one_topic)
        r = await self._call(API_OFFSET_COMMIT, ver, w)
        if ver >= 3:
            r.i32()
        out: List[Tuple[str, int, int]] = []

        def one_rsp():
            name = r.string()
            r.array(lambda: out.append((name, r.i32(), r.i16())))

        r.array(one_rsp)
        return out

    async def offset_fetch(
        self, group: str, tps: List[Tuple[str, int]], ver: int = 1
    ) -> List[Tuple[str, int, Optional[int]]]:
        """Returns [(topic, partition, committed offset | None)]."""
        by_topic: Dict[str, List[int]] = {}
        for t, p in tps:
            by_topic.setdefault(t, []).append(p)
        w = self._header(API_OFFSET_FETCH, ver)
        w.string(group)

        def one_topic(ww: Writer, item) -> None:
            name, parts = item
            ww.string(name)
            ww.array(parts, lambda w2, p: w2.i32(p))

        w.array(sorted(by_topic.items()), one_topic)
        r = await self._call(API_OFFSET_FETCH, ver, w)
        if ver >= 3:
            r.i32()
        out: List[Tuple[str, int, Optional[int]]] = []

        def one_rsp():
            name = r.string()

            def one_part():
                index = r.i32()
                off = r.i64()
                if ver >= 5:
                    r.i32()
                r.nullable_string()
                r.i16()
                out.append((name, index, None if off < 0 else off))

            r.array(one_part)

        r.array(one_rsp)
        if ver >= 2:
            r.i16()
        return out

    # -- the canonical session (the acceptance-criteria flow) ------------------

    async def group_session(
        self, group: str, topics: List[str], member_id: str = ""
    ) -> Tuple[str, int, List[Tuple[str, int]]]:
        """Join/Sync to a working assignment: the Join->Sync half of the
        canonical consumer-group session. A concurrent joiner can move
        the generation between our Join and Sync — the coordinator
        answers REBALANCE_IN_PROGRESS and, like a stock client, we
        rejoin (keeping the member id) until a generation holds still.
        Returns (member, generation, assignment)."""
        err, host, port = await self.find_coordinator(group)
        _check(err, "FindCoordinator")
        assert host, "coordinator must name itself"
        member = member_id
        for _attempt in range(50):
            err, gen, member, _leader, _members = await self.join_group(
                group, member, topics
            )
            _check(err, "JoinGroup")
            err, assignment = await self.sync_group(group, gen, member)
            if err in (27, 22):  # REBALANCE_IN_PROGRESS / ILLEGAL_GENERATION
                continue
            _check(err, "SyncGroup")
            return member, gen, assignment
        raise ProbeError(27, "SyncGroup: rebalance never settled")
