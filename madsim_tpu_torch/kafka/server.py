"""The broker server node (madsim-rdkafka/src/sim/sim_broker.rs).

``SimBroker().serve(addr)``: one request enum exchange per ``connect1``
connection — CreateTopic / DeleteTopic / Produce / Fetch / FetchMetadata /
FetchWatermarks / OffsetsForTimes (sim_broker.rs:14-77) — plus the
consumer-group ops (join/leave/heartbeat/commit/committed), which the
reference sim does not model (broker.py ``Group``).
"""

from __future__ import annotations

from typing import Any, Optional

from .. import task as mstask
from ..context import current_handle
from ..net.endpoint import Endpoint as NetEndpoint
from .broker import Broker, KafkaBrokerError


class SimBroker:
    # executor/clock bindings as class attributes so the real-mode twin
    # (real/kafka.py) rebinds them to asyncio + the wall clock while
    # reusing the whole request dispatcher (the sim/std split of
    # madsim-rdkafka/src/lib.rs:3-12)
    _spawn = staticmethod(mstask.spawn)

    @staticmethod
    async def _bind(addr: "str | tuple") -> Any:
        return await NetEndpoint.bind(addr)

    @staticmethod
    def _now_ms() -> int:
        return current_handle().time.now_time_ns() // 1_000_000

    def __init__(self) -> None:
        self.broker = Broker()
        #: set once the listener is bound (port-0 discovery, real mode)
        self.bound_addr: "tuple | None" = None

    async def serve(self, addr: "str | tuple") -> None:
        ep = await self._bind(addr)
        local = getattr(ep, "local_addr", None)
        self.bound_addr = local() if callable(local) else None
        while True:
            tx, rx, _src = await ep.accept1()
            self._spawn(self._serve_conn(tx, rx), name="kafka-conn")

    async def _serve_conn(self, tx: Any, rx: Any) -> None:
        try:
            req = await rx.recv()
            if req is None:
                return
            try:
                await tx.send(("ok", self._handle(req)))
            except KafkaBrokerError as e:
                await tx.send(("err", str(e)))
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            tx.close()

    def _handle(self, req: tuple) -> Any:
        b = self.broker
        op = req[0]
        if op == "create_topic":
            _, name, partitions = req
            b.create_topic(name, partitions)
            return None
        if op == "delete_topic":
            b.delete_topic(req[1])
            return None
        if op == "produce":
            _, topic, partition, key, payload = req
            return b.produce(topic, partition, key, payload, self._now_ms())
        if op == "fetch":
            _, topic, partition, offset, fmax, pmax = req
            return b.fetch(topic, partition, offset, fmax, pmax)
        if op == "watermarks":
            _, topic, partition = req
            return b.watermarks(topic, partition)
        if op == "offsets_for_times":
            return b.offsets_for_times(req[1])
        if op == "metadata":
            return b.metadata(req[1])
        if op == "join_group":
            _, group, member, topics = req
            return b.join_group(group, member, topics)
        if op == "leave_group":
            _, group, member = req
            b.leave_group(group, member)
            return None
        if op == "heartbeat":
            _, group, member = req
            return b.group_state(group, member)
        if op == "commit":
            # legacy 3-tuple requests carry no generation (fence skipped)
            _, group, offsets = req[:3]
            b.commit_offsets(group, offsets, req[3] if len(req) > 3 else None)
            return None
        if op == "committed":
            _, group, tps = req
            return b.committed_offsets(group, tps)
        raise KafkaBrokerError(f"unknown request {op!r}")
