"""Real-mode Kafka twin: the unchanged client API over the GENUINE
Kafka binary wire protocol.

The reference's madsim-rdkafka compiles to the *real* rdkafka bindings
without ``--cfg madsim`` (madsim-rdkafka/src/lib.rs:3-12). No librdkafka
exists in this image, so real mode pairs the unchanged client surface
(producers, consumers, admin) with the framework's own ``Broker`` served
over **real Kafka protocol TCP** (``kafka/wire.py``: 4-byte framing,
correlation-id headers, record-batch v2 + CRC32C) — any stock Kafka
client can connect to the same port. The client classes here translate
their operations onto genuine wire requests (client-side partitioning,
Join/Sync/Heartbeat group sessions, OffsetCommit/OffsetFetch), with
wall-clock produce timestamps and poll deadlines::

    from madsim_tpu_torch.real import kafka

    await kafka.SimBroker().serve(("127.0.0.1", 9092))      # server task
    p = await config.create(kafka.FutureProducer)           # client side

The pre-wire private framed codec stays A/B-able behind
``MADSIM_KAFKA_LEGACY=1`` (both sides switch together, like the engine's
``legacy_queue`` layout flag): useful for bisecting a wire-layer bug
against the old transport, never the default.
"""

from __future__ import annotations

import os
import zlib
from typing import Any, Dict, List, Optional, Tuple
import time as _walltime

from ..kafka import wire as kwire
from ..kafka.broker import OwnedMessage, Watermarks
from ..kafka.client import (
    AdminClient as _SimAdminClient,
    BaseConsumer as _SimBaseConsumer,
    BaseProducer as _SimBaseProducer,
    BaseRecord,
    ClientConfig,
    FutureProducer as _SimFutureProducer,
    FutureRecord,
    KafkaError,
    StreamConsumer as _SimStreamConsumer,
    TopicPartitionList,
    _BrokerConn as _SimBrokerConn,
)
from ..kafka.probe import ProbeClient, ProbeError, RealTransport
from ..kafka.server import SimBroker as _SimBroker
from . import codec, stream
from . import time as rtime
from .runtime import spawn

# the legacy wire vocabulary (A/B path responses carry these dataclasses)
codec.register(OwnedMessage)
codec.register(Watermarks)


def _legacy_wire() -> bool:
    return os.environ.get("MADSIM_KAFKA_LEGACY", "") in ("1", "true")


class SimBroker(_SimBroker):
    """The broker on a real listener: genuine Kafka wire by default,
    the legacy private codec under ``MADSIM_KAFKA_LEGACY=1``."""

    # legacy-path bindings (the pre-wire framed-codec dispatcher)
    _spawn = staticmethod(spawn)

    @staticmethod
    async def _bind(addr: "str | tuple") -> Any:
        return await stream.StreamListener.bind(addr)

    @staticmethod
    def _now_ms() -> int:
        return _walltime.time_ns() // 1_000_000

    def __init__(self) -> None:
        super().__init__()
        self.wire_server: Optional[kwire.WireServer] = None

    async def serve(self, addr: "str | tuple") -> None:
        if _legacy_wire():
            await super().serve(addr)
            return
        ws = kwire.WireServer(broker=self.broker)
        self.wire_server = ws
        await ws.start(addr)
        self.bound_addr = ws.bound_addr
        try:
            await ws._core._stopped.wait()
        finally:
            ws._core._teardown()


Broker = SimBroker  # the natural real-mode name


class _WireAdapter:
    """Translate the client classes' op tuples onto genuine wire calls.

    Holds one persistent TCP connection plus the client-side state real
    Kafka keeps client-side too: a metadata cache and round-robin cursor
    for partitioning (the broker no longer partitions for us — the real
    protocol's Produce names a partition), and per-group session state
    (member id, generation, subscription, assignment) so a heartbeat can
    answer ``(generation, assignment)`` and a REBALANCE_IN_PROGRESS can
    trigger the eager protocol's rejoin."""

    def __init__(self, addr: str):
        import asyncio

        self._addr = addr
        self._client: Optional[ProbeClient] = None
        self._parts: Dict[str, int] = {}
        self._rr: Dict[str, int] = {}
        self._groups: Dict[str, Dict[str, Any]] = {}
        # one connection carries every call: serialize them, or two
        # concurrent ops (gather'd sends — fine on the legacy per-call
        # transport) would interleave frames on one stream reader
        self._lock = asyncio.Lock()

    async def _c(self) -> ProbeClient:
        if self._client is None:
            try:
                self._client = ProbeClient(
                    await RealTransport.connect(self._addr)
                )
            except (ConnectionError, OSError) as e:
                raise KafkaError(f"broker transport error: {e}") from None
        return self._client

    def _drop_conn(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None

    @staticmethod
    def _err(code: int, what: str) -> KafkaError:
        name = kwire.ERROR_NAMES.get(code, f"error {code}")
        return KafkaError(f"{name}: {what}")

    async def call(self, req: tuple) -> Any:
        async with self._lock:
            try:
                return await self._dispatch(req)
            except (ConnectionError, OSError) as e:
                self._drop_conn()
                raise KafkaError(f"broker transport error: {e}") from None
            except ProbeError as e:
                self._drop_conn()
                raise KafkaError(f"broker transport error: {e}") from None

    async def _partitions(self, topic: str) -> int:
        n = self._parts.get(topic)
        if n is None:
            md = await (await self._c()).metadata([topic])
            n = md.get(topic)
            if n is None:
                raise KafkaError(f"unknown topic: {topic!r}")
            self._parts[topic] = n
        return n

    async def _dispatch(self, req: tuple) -> Any:
        c = await self._c()
        op = req[0]

        if op == "create_topic":
            _, name, partitions = req
            (name, err, msg), = await c.create_topics([(name, partitions)])
            if err != kwire.ERR_NONE:
                raise KafkaError(msg or self._err(err, name).args[0])
            return None

        if op == "delete_topic":
            (name, err), = await c.delete_topics([req[1]])
            self._parts.pop(name, None)
            if err != kwire.ERR_NONE:
                raise KafkaError(f"unknown topic: {name!r}")
            return None

        if op == "produce":
            _, topic, partition, key, payload = req
            if partition is None:
                n = await self._partitions(topic)
                if key is not None:
                    partition = zlib.crc32(key) % n
                else:
                    partition = self._rr.get(topic, 0) % n
                    self._rr[topic] = self._rr.get(topic, 0) + 1
            err, base = await c.produce(
                topic, partition,
                [(_walltime.time_ns() // 1_000_000, key, payload)],
            )
            if err != kwire.ERR_NONE:
                raise self._err(err, f"{topic}[{partition}]")
            return partition, base

        if op == "fetch":
            _, topic, partition, offset, fmax, pmax = req
            err, _high, rows = await c.fetch(
                topic, partition, offset, max_bytes=fmax,
                partition_max_bytes=pmax,
            )
            if err != kwire.ERR_NONE:
                raise self._err(err, f"{topic}[{partition}]")
            return [
                OwnedMessage(topic, partition, off, ts, k, v)
                for off, ts, k, v in rows
            ]

        if op == "watermarks":
            _, topic, partition = req
            err, _ts, low = await c.list_offsets(topic, partition, -2)
            if err != kwire.ERR_NONE:
                raise self._err(err, f"{topic}[{partition}]")
            err, _ts, high = await c.list_offsets(topic, partition, -1)
            if err != kwire.ERR_NONE:
                raise self._err(err, f"{topic}[{partition}]")
            return Watermarks(low=low, high=high)

        if op == "offsets_for_times":
            out = []
            for topic, partition, ts in req[1]:
                err, _t, off = await c.list_offsets(topic, partition, ts)
                if err != kwire.ERR_NONE:
                    raise self._err(err, f"{topic}[{partition}]")
                out.append((topic, partition, None if off < 0 else off))
            return out

        if op == "metadata":
            topic = req[1]
            md = await c.metadata(None if topic is None else [topic])
            for name, n in list(md.items()):
                if n is None:
                    raise KafkaError(f"unknown topic: {name!r}")
            return md

        if op == "join_group":
            _, group, member, topics = req
            return await self._join(c, group, member or "", list(topics))

        if op == "leave_group":
            _, group, member = req
            err = await c.leave_group(group, member)
            self._groups.pop(group, None)
            if err not in (kwire.ERR_NONE, kwire.ERR_GROUP_ID_NOT_FOUND):
                raise self._err(err, group)
            return None

        if op == "heartbeat":
            _, group, member = req
            st = self._groups.get(group)
            if st is None or st["member"] != member:
                raise KafkaError(
                    f"unknown member {member!r} in group {group!r}"
                )
            err = await c.heartbeat(group, st["gen"], member)
            if err == kwire.ERR_NONE:
                return st["gen"], st["assignment"]
            if err in (kwire.ERR_REBALANCE_IN_PROGRESS,
                       kwire.ERR_ILLEGAL_GENERATION,
                       kwire.ERR_UNKNOWN_MEMBER_ID):
                # the eager protocol: a moved generation means rejoin
                _m, gen, assignment = await self._join(
                    c, group, member, st["topics"]
                )
                return gen, assignment
            raise self._err(err, group)

        if op == "commit":
            _, group, offsets = req[:3]
            generation = req[3] if len(req) > 3 else None
            st = self._groups.get(group)
            member = st["member"] if st else ""
            results = await c.offset_commit(
                group, -1 if generation is None else generation,
                member, [tuple(o) for o in offsets],
            )
            for topic, partition, err in results:
                if err == kwire.ERR_ILLEGAL_GENERATION:
                    raise KafkaError(
                        f"ILLEGAL_GENERATION: commit for group {group!r} "
                        f"carries a stale generation (zombie member — "
                        "rejoin before committing)"
                    )
                if err != kwire.ERR_NONE:
                    raise self._err(err, f"{topic}[{partition}]")
            return None

        if op == "committed":
            _, group, tps = req
            got = await c.offset_fetch(group, [tuple(tp) for tp in tps])
            by_tp = {(t, p): off for t, p, off in got}
            return [(t, p, by_tp.get((t, p))) for t, p in tps]

        raise KafkaError(f"unknown request {op!r}")

    async def _join(
        self, c: ProbeClient, group: str, member: str, topics: List[str]
    ) -> Tuple[str, int, List[Tuple[str, int]]]:
        member_id, gen, assignment = await c.group_session(
            group, topics, member_id=member
        )
        self._groups[group] = {
            "member": member_id, "gen": gen,
            "topics": list(topics), "assignment": assignment,
        }
        return member_id, gen, assignment


class _BrokerConn(_SimBrokerConn):
    """The per-client connection: wire adapter by default, the legacy
    one-exchange framed codec under ``MADSIM_KAFKA_LEGACY=1``."""

    _connect = staticmethod(stream.connect)  # legacy path transport

    def __init__(self, config: ClientConfig):
        super().__init__(config)
        self._wire = None if _legacy_wire() else _WireAdapter(self._addr)

    async def call(self, req: tuple) -> Any:
        if self._wire is None:
            return await super().call(req)
        return await self._wire.call(req)


class BaseProducer(_SimBaseProducer):
    _conn_cls = _BrokerConn


class FutureProducer(_SimFutureProducer):
    _conn_cls = _BrokerConn
    _sleep = staticmethod(rtime.sleep)


class BaseConsumer(_SimBaseConsumer):
    _conn_cls = _BrokerConn
    _sleep = staticmethod(rtime.sleep)
    _now_instant = staticmethod(rtime.now_instant)


class StreamConsumer(_SimStreamConsumer, BaseConsumer):
    pass


class AdminClient(_SimAdminClient):
    _conn_cls = _BrokerConn


__all__ = [
    "AdminClient",
    "BaseConsumer",
    "BaseProducer",
    "BaseRecord",
    "Broker",
    "ClientConfig",
    "FutureProducer",
    "FutureRecord",
    "KafkaError",
    "OwnedMessage",
    "SimBroker",
    "StreamConsumer",
    "TopicPartitionList",
    "Watermarks",
]
