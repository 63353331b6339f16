"""Kafka clients (madsim-rdkafka/src/sim/{producer,consumer,admin}.rs).

API mirrors rust-rdkafka's shape: a string-map ``ClientConfig``
(consumer.rs:70-103), ``BaseProducer`` buffering until ``flush``,
``FutureProducer`` with ``linger.ms`` batching delay, ``BaseConsumer`` with
assign/seek/poll fetch loops honoring the fetch byte budgets, a
``StreamConsumer`` that awaits messages, and an ``AdminClient``.
Consumer groups (group.id / rebalance / committed offsets / auto-commit)
ARE modeled — beyond the reference, whose sim leaves assignment manual
(see BaseConsumer's docstring and broker.py ``Group``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Type, TypeVar

from .. import time as mstime
from ..net.endpoint import connect1_ephemeral, exchange1
from .broker import OwnedMessage, Watermarks

T = TypeVar("T")


class KafkaError(Exception):
    pass


class ClientConfig:
    """String-map config (rdkafka ``ClientConfig``)."""

    def __init__(self) -> None:
        self._map: Dict[str, str] = {}

    def set(self, key: str, value: "str | int | float") -> "ClientConfig":
        self._map[key] = str(value)
        return self

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._map.get(key, default)

    def get_int(self, key: str, default: int) -> int:
        v = self._map.get(key)
        return int(v) if v is not None else default

    def get_float(self, key: str, default: float) -> float:
        v = self._map.get(key)
        return float(v) if v is not None else default

    async def create(self, cls: Type[T]) -> T:
        """rdkafka ``config.create::<T>()``."""
        return cls(self)  # type: ignore[call-arg]


class _BrokerConn:
    """One request/response exchange per operation (sim_broker protocol)."""

    # transport hook — real/kafka.py dials framed TCP instead
    _connect = staticmethod(connect1_ephemeral)

    def __init__(self, config: ClientConfig):
        servers = config.get("bootstrap.servers")
        if not servers:
            raise KafkaError("bootstrap.servers is required")
        self._addr = servers.split(",")[0]

    async def call(self, req: tuple) -> Any:
        try:
            tx, rx = await self._connect(self._addr)
            rsp = await exchange1(tx, rx, req)
        except (ConnectionError, OSError) as e:
            raise KafkaError(f"broker transport error: {e}") from None
        if rsp is None:
            raise KafkaError("broker connection closed")
        kind, payload = rsp
        if kind == "err":
            raise KafkaError(payload)
        return payload


# -- records ----------------------------------------------------------------


@dataclass
class BaseRecord:
    topic: str
    partition: Optional[int] = None
    key: Optional[bytes] = None
    payload: Optional[bytes] = None

    @staticmethod
    def to(topic: str) -> "BaseRecord":
        return BaseRecord(topic)

    def with_partition(self, p: int) -> "BaseRecord":
        self.partition = p
        return self

    def with_key(self, key: "bytes | str") -> "BaseRecord":
        self.key = key.encode() if isinstance(key, str) else key
        return self

    def with_payload(self, payload: "bytes | str") -> "BaseRecord":
        self.payload = payload.encode() if isinstance(payload, str) else payload
        return self


FutureRecord = BaseRecord  # same shape; only the send path differs


# -- producers (sim/producer.rs) --------------------------------------------


class BaseProducer:
    """Buffers records locally until ``flush`` (sim producer semantics)."""

    _conn_cls = _BrokerConn  # real/kafka.py overrides

    def __init__(self, config: ClientConfig):
        self._conn = self._conn_cls(config)
        self._buffer: List[BaseRecord] = []

    def send(self, record: BaseRecord) -> None:
        self._buffer.append(record)

    def poll(self, _timeout_s: float = 0.0) -> None:
        """librdkafka poll pump — a no-op here (no delivery callbacks)."""

    async def flush(self, _timeout_s: float = 30.0) -> None:
        buffered, self._buffer = self._buffer, []
        for rec in buffered:
            await self._conn.call(
                ("produce", rec.topic, rec.partition, rec.key, rec.payload)
            )

    def in_flight_count(self) -> int:
        return len(self._buffer)


class FutureProducer:
    """Per-record async send returning (partition, offset); honors a
    ``linger.ms`` batching delay on virtual time."""

    _conn_cls = _BrokerConn  # real/kafka.py overrides
    _sleep = staticmethod(mstime.sleep)

    def __init__(self, config: ClientConfig):
        self._conn = self._conn_cls(config)
        self._linger_s = config.get_float("linger.ms", 0.0) / 1000.0

    async def send(
        self, record: BaseRecord, _queue_timeout_s: float = 0.0
    ) -> Tuple[int, int]:
        if self._linger_s > 0:
            await self._sleep(self._linger_s)
        return tuple(
            await self._conn.call(
                ("produce", record.topic, record.partition, record.key, record.payload)
            )
        )


# -- consumers (sim/consumer.rs) --------------------------------------------


@dataclass
class _Assignment:
    topic: str
    partition: int
    position: int  # next offset to FETCH (fetch batches run ahead)
    consumed: int = 0  # next offset after the last message RETURNED by poll
    # (commits use `consumed`, not `position`: a fetch batch sitting
    # unread in the client buffer must not be committed away)


class TopicPartitionList:
    def __init__(self) -> None:
        self.elements: List[Tuple[str, int, Optional[int]]] = []

    def add_partition(self, topic: str, partition: int) -> "TopicPartitionList":
        self.elements.append((topic, partition, None))
        return self

    def add_partition_offset(
        self, topic: str, partition: int, offset: int
    ) -> "TopicPartitionList":
        self.elements.append((topic, partition, offset))
        return self


class BaseConsumer:
    """assign/seek/poll fetch loop (sim consumer; fetch byte budgets from
    config: fetch.max.bytes / max.partition.fetch.bytes).

    With a ``group.id`` in the config, ``subscribe`` joins a broker-side
    consumer group (range assignor, eager rebalance, committed offsets —
    **beyond the reference**, whose sim has no groups): partitions are
    split across the group's members, a generation bump observed at the
    next poll triggers reassignment from committed offsets, and
    ``enable.auto.commit`` (default true, interval
    ``auto.commit.interval.ms``) commits consumed positions on poll.
    Without a group id, ``subscribe`` keeps the reference sim's semantics:
    the consumer takes every partition from the low watermark."""

    POLL_TICK_S = 0.01

    _conn_cls = _BrokerConn  # real/kafka.py overrides
    _sleep = staticmethod(mstime.sleep)
    _now_instant = staticmethod(mstime.now_instant)

    def __init__(self, config: ClientConfig):
        self._conn = self._conn_cls(config)
        self._fetch_max = config.get_int("fetch.max.bytes", 52_428_800)
        self._partition_max = config.get_int("max.partition.fetch.bytes", 1_048_576)
        self._assignments: List[_Assignment] = []
        self._buffer: List[OwnedMessage] = []
        self._rr = 0
        self._group = config.get("group.id")
        self._member: Optional[str] = None
        self._generation = -1
        self._auto_commit = config.get("enable.auto.commit", "true") == "true"
        self._commit_interval_s = (
            config.get_float("auto.commit.interval.ms", 5000.0) / 1000.0
        )
        self._last_commit = None  # Instant of the last auto-commit

    async def subscribe(self, topics: List[str]) -> None:
        """Replaces any previous subscription, like rdkafka's subscribe.
        Group mode (``group.id`` set): join the group and take the range
        assignment. Groupless: assign every partition from the beginning
        (the reference sim's subscription = full assignment)."""
        self._assignments.clear()
        self._buffer.clear()
        if self._group is not None:
            member, gen, assigned = await self._conn.call(
                ("join_group", self._group, self._member, list(topics))
            )
            self._member = member
            await self._apply_assignment(gen, assigned)
            return
        for topic in topics:
            meta = await self._conn.call(("metadata", topic))
            for p in range(meta[topic]):
                await self._assign_one(topic, p, None)

    async def _apply_assignment(
        self, generation: int, assigned: List[Tuple[str, int]]
    ) -> None:
        """Adopt a group assignment: start each partition at its committed
        offset, or the low watermark when nothing was ever committed."""
        self._generation = generation
        self._assignments.clear()
        self._buffer.clear()
        self._rr = 0
        committed = await self._conn.call(
            ("committed", self._group, list(assigned))
        )
        for topic, partition, offset in committed:
            await self._assign_one(topic, partition, offset)

    async def _maybe_rebalance(self) -> None:
        """Group heartbeat: adopt the new assignment when the generation
        moved (another member joined or left). Commits consumed positions
        FIRST when auto-commit is on (librdkafka's commit-on-revoke),
        which narrows — but, as in Kafka's eager protocol, cannot close —
        the at-least-once redelivery window: a member that fetches a
        handed-over partition BEFORE the old owner's next poll commits
        will re-deliver that owner's uncommitted tail. Exactly-once needs
        explicit commit() discipline, same as the real system."""
        gen, assigned = await self._conn.call(
            ("heartbeat", self._group, self._member)
        )
        if gen != self._generation:
            had_generation = self._generation >= 0
            # adopt the observed generation, then commit ONLY the
            # positions this member retains under the new assignment.
            # Committing a revoked partition here could roll the group's
            # offset backward past the new owner's progress — the exact
            # rollback the broker's generation fence exists to stop; a
            # member that merely heard the new generation number must not
            # launder stale positions through it. The revoked tail is
            # redelivered to the new owner: the eager protocol's
            # at-least-once window, as in Kafka itself.
            self._generation = gen
            if self._auto_commit and had_generation:
                keep = {tuple(tp) for tp in assigned}
                offsets = [
                    (a.topic, a.partition, a.consumed)
                    for a in self._assignments
                    if (a.topic, a.partition) in keep
                ]
                if offsets:
                    await self._conn.call(
                        ("commit", self._group, offsets, gen)
                    )
            await self._apply_assignment(gen, assigned)

    async def commit(self) -> None:
        """Commit the current consume positions (rdkafka commit_consumer_
        state shape). No-op outside a group."""
        if self._group is None or not self._assignments:
            return
        await self._conn.call(
            ("commit", self._group,
             [(a.topic, a.partition, a.consumed) for a in self._assignments],
             self._generation)
        )

    async def committed(self, tpl: "TopicPartitionList") -> List[Tuple[str, int, Optional[int]]]:
        """The group's committed offsets for the listed partitions."""
        if self._group is None:
            raise KafkaError("committed() requires a group.id")
        return await self._conn.call(
            ("committed", self._group,
             [(t, p) for t, p, _o in tpl.elements])
        )

    async def unsubscribe(self) -> None:
        """Leave the group (triggering a rebalance for the survivors) and
        drop all assignments."""
        if self._group is not None and self._member is not None:
            if self._auto_commit:
                await self.commit()
            await self._conn.call(("leave_group", self._group, self._member))
            self._member = None
            self._generation = -1
        self._assignments.clear()
        self._buffer.clear()

    async def assign(self, tpl: TopicPartitionList) -> None:
        self._assignments.clear()
        self._buffer.clear()
        for topic, partition, offset in tpl.elements:
            await self._assign_one(topic, partition, offset)

    async def _assign_one(self, topic: str, partition: int, offset: Optional[int]) -> None:
        if offset is None:
            wm: Watermarks = await self._conn.call(("watermarks", topic, partition))
            offset = wm.low
        self._assignments.append(
            _Assignment(topic, partition, offset, consumed=offset)
        )

    def seek(self, topic: str, partition: int, offset: int) -> None:
        for a in self._assignments:
            if a.topic == topic and a.partition == partition:
                a.position = offset
                a.consumed = offset
                self._buffer = [
                    m for m in self._buffer
                    if not (m.topic == topic and m.partition == partition)
                ]
                return
        raise KafkaError(f"not assigned: {topic}[{partition}]")

    async def _fetch_round(self) -> None:
        if not self._assignments:
            return
        n = len(self._assignments)
        for i in range(n):
            a = self._assignments[(self._rr + i) % n]
            msgs: List[OwnedMessage] = await self._conn.call(
                ("fetch", a.topic, a.partition, a.position,
                 self._fetch_max, self._partition_max)
            )
            if msgs:
                a.position = msgs[-1].offset + 1
                self._buffer.extend(msgs)
                self._rr = (self._rr + i + 1) % n
                return
        self._rr = (self._rr + 1) % n

    async def poll(self, timeout_s: float = 1.0) -> Optional[OwnedMessage]:
        deadline = self._now_instant() + timeout_s
        heartbeated = False
        while True:
            if self._buffer:
                # buffered message ready: no broker round-trips at all —
                # draining a fetch batch must not pay a heartbeat per
                # message (rebalance detection waits for the next empty
                # poll, like librdkafka's background-interval heartbeat)
                return self._consume(self._buffer.pop(0))
            if (
                self._group is not None
                and self._member is not None
                and not heartbeated
            ):
                # at most one heartbeat per poll() call (idle 1 s polls
                # spin ~100 ticks; re-heartbeating each tick buys nothing)
                heartbeated = True
                await self._maybe_rebalance()
                await self._maybe_auto_commit()
                if self._buffer:  # rebalance may not clear a fresh fetch
                    return self._consume(self._buffer.pop(0))
            await self._fetch_round()
            if self._buffer:
                return self._consume(self._buffer.pop(0))
            if self._now_instant() >= deadline:
                return None
            await self._sleep(self.POLL_TICK_S)

    def _consume(self, msg: OwnedMessage) -> OwnedMessage:
        for a in self._assignments:
            if a.topic == msg.topic and a.partition == msg.partition:
                a.consumed = msg.offset + 1
                break
        return msg

    async def _maybe_auto_commit(self) -> None:
        """Commit positions once per auto.commit.interval.ms of virtual
        time (rdkafka's enable.auto.commit behavior)."""
        if not self._auto_commit:
            return
        now = self._now_instant()
        if self._last_commit is None:
            self._last_commit = now
            return
        if now >= self._last_commit + self._commit_interval_s:
            await self.commit()
            self._last_commit = now

    async def fetch_watermarks(
        self, topic: str, partition: int, _timeout_s: float = 1.0
    ) -> Tuple[int, int]:
        wm: Watermarks = await self._conn.call(("watermarks", topic, partition))
        return wm.low, wm.high

    async def offsets_for_times(
        self, tpl: TopicPartitionList, _timeout_s: float = 1.0
    ) -> List[Tuple[str, int, Optional[int]]]:
        queries = [(t, p, o or 0) for t, p, o in tpl.elements]
        return await self._conn.call(("offsets_for_times", queries))


class StreamConsumer(BaseConsumer):
    """Await-forever message stream (rdkafka ``StreamConsumer::recv``)."""

    async def recv(self) -> OwnedMessage:
        while True:
            msg = await self.poll(timeout_s=60.0)
            if msg is not None:
                return msg

    def stream(self) -> "StreamConsumer":
        return self

    def __aiter__(self) -> "StreamConsumer":
        return self

    async def __anext__(self) -> OwnedMessage:
        return await self.recv()


# -- admin (sim/admin.rs) ---------------------------------------------------


@dataclass
class NewTopic:
    name: str
    num_partitions: int = 1

    @staticmethod
    def new(name: str, num_partitions: int) -> "NewTopic":
        return NewTopic(name, num_partitions)


class AdminClient:
    _conn_cls = _BrokerConn  # real/kafka.py overrides

    def __init__(self, config: ClientConfig):
        self._conn = self._conn_cls(config)

    async def create_topics(self, topics: List[NewTopic]) -> List[Optional[str]]:
        """Returns per-topic error strings (None = success), like the
        rdkafka admin result vector."""
        out: List[Optional[str]] = []
        for t in topics:
            try:
                await self._conn.call(("create_topic", t.name, t.num_partitions))
                out.append(None)
            except KafkaError as e:
                out.append(str(e))
        return out

    async def delete_topics(self, names: List[str]) -> List[Optional[str]]:
        out: List[Optional[str]] = []
        for name in names:
            try:
                await self._conn.call(("delete_topic", name))
                out.append(None)
            except KafkaError as e:
                out.append(str(e))
        return out

    async def fetch_metadata(self, topic: Optional[str] = None) -> Dict[str, int]:
        return await self._conn.call(("metadata", topic))
