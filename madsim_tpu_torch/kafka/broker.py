"""The broker state machine (madsim-rdkafka/src/sim/broker.rs).

Pure deterministic state: topics → partitions → append-only message logs
with log-end-offset/low-watermark bookkeeping, round-robin partition
assignment for keyless produce (broker.rs:80-101), offset-for-timestamp
lookup, and fetch honoring ``fetch_max_bytes`` / ``max_partition_fetch_
bytes`` (broker.rs:104-146).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class KafkaBrokerError(Exception):
    """Broker-side error (serialized back to clients as KafkaError)."""


@dataclass
class OwnedMessage:
    """rdkafka ``OwnedMessage``."""

    topic: str
    partition: int
    offset: int
    timestamp_ms: int
    key: Optional[bytes]
    payload: Optional[bytes]

    def size(self) -> int:
        return len(self.key or b"") + len(self.payload or b"")


@dataclass
class Watermarks:
    low: int
    high: int


@dataclass
class Partition:
    log: List[OwnedMessage] = field(default_factory=list)
    base_offset: int = 0  # low watermark (nothing is ever compacted here)

    @property
    def log_end_offset(self) -> int:
        return self.base_offset + len(self.log)


@dataclass
class Topic:
    name: str
    partitions: List[Partition]
    next_rr: int = 0  # round-robin cursor for keyless produce


@dataclass
class Group:
    """One consumer group: membership, the range assignment of the
    current generation, and committed offsets. **Beyond the reference**
    — madsim-rdkafka's sim models no consumer groups at all (assignment
    is manual, consumer.rs); this is classic group semantics with a
    deterministic assignor so sim schedules stay reproducible."""

    members: Dict[str, List[str]] = field(default_factory=dict)  # id -> topics
    generation: int = 0
    assignments: Dict[str, List[Tuple[str, int]]] = field(default_factory=dict)
    committed: Dict[Tuple[str, int], int] = field(default_factory=dict)
    next_member: int = 0


class Broker:
    """The single global broker (one mutex-guarded instance in the
    reference, sim_broker.rs:14-21)."""

    def __init__(self) -> None:
        self.topics: Dict[str, Topic] = {}
        self.groups: Dict[str, Group] = {}

    # -- admin -------------------------------------------------------------

    def create_topic(self, name: str, num_partitions: int) -> None:
        if name in self.topics:
            raise KafkaBrokerError(f"topic already exists: {name!r}")
        if num_partitions <= 0:
            raise KafkaBrokerError("num_partitions must be positive")
        self.topics[name] = Topic(name, [Partition() for _ in range(num_partitions)])

    def delete_topic(self, name: str) -> None:
        if name not in self.topics:
            raise KafkaBrokerError(f"unknown topic: {name!r}")
        del self.topics[name]

    def _topic(self, name: str) -> Topic:
        t = self.topics.get(name)
        if t is None:
            raise KafkaBrokerError(f"unknown topic: {name!r}")
        return t

    def _partition(self, topic: str, partition: int) -> Partition:
        t = self._topic(topic)
        if not 0 <= partition < len(t.partitions):
            raise KafkaBrokerError(f"unknown partition: {topic}[{partition}]")
        return t.partitions[partition]

    # -- produce (broker.rs:80-101) ----------------------------------------

    def produce(
        self,
        topic: str,
        partition: Optional[int],
        key: Optional[bytes],
        payload: Optional[bytes],
        timestamp_ms: int,
    ) -> Tuple[int, int]:
        """Append one message; keyless/partitionless records go round-robin.
        Returns (partition, offset)."""
        t = self._topic(topic)
        if partition is None:
            if key is not None:
                # stable key hash (rdkafka uses crc32 of the key)
                import zlib

                partition = zlib.crc32(key) % len(t.partitions)
            else:
                partition = t.next_rr % len(t.partitions)
                t.next_rr += 1
        p = self._partition(topic, partition)
        msg = OwnedMessage(
            topic=topic,
            partition=partition,
            offset=p.log_end_offset,
            timestamp_ms=timestamp_ms,
            key=key,
            payload=payload,
        )
        p.log.append(msg)
        return partition, msg.offset

    # -- fetch (broker.rs:104-146) -----------------------------------------

    def fetch(
        self,
        topic: str,
        partition: int,
        offset: int,
        fetch_max_bytes: int,
        max_partition_fetch_bytes: int,
    ) -> List[OwnedMessage]:
        p = self._partition(topic, partition)
        start = max(offset, p.base_offset) - p.base_offset
        out: List[OwnedMessage] = []
        budget = min(fetch_max_bytes, max_partition_fetch_bytes)
        for msg in p.log[start:]:
            if out and msg.size() > budget:
                break
            out.append(msg)
            budget -= msg.size()
            if budget <= 0:
                break
        return out

    # -- lookups -----------------------------------------------------------

    def watermarks(self, topic: str, partition: int) -> Watermarks:
        p = self._partition(topic, partition)
        return Watermarks(low=p.base_offset, high=p.log_end_offset)

    def offsets_for_times(
        self, queries: List[Tuple[str, int, int]]
    ) -> List[Tuple[str, int, Optional[int]]]:
        """For each (topic, partition, ts): the first offset with
        timestamp >= ts, or None past the end (broker.rs offset lookup)."""
        out = []
        for topic, partition, ts in queries:
            p = self._partition(topic, partition)
            found: Optional[int] = None
            for msg in p.log:
                if msg.timestamp_ms >= ts:
                    found = msg.offset
                    break
            out.append((topic, partition, found))
        return out

    def metadata(self, topic: Optional[str] = None) -> Dict[str, int]:
        """topic → partition count (FetchMetadata)."""
        if topic is not None:
            return {topic: len(self._topic(topic).partitions)}
        return {name: len(t.partitions) for name, t in sorted(self.topics.items())}

    # -- consumer groups (beyond the reference — see Group) -----------------

    def _group(self, group_id: str) -> Group:
        """Create-on-first-use — the JOIN path only."""
        g = self.groups.get(group_id)
        if g is None:
            g = self.groups[group_id] = Group()
        return g

    def _group_lookup(self, group_id: str) -> Group:
        """Every non-join path: a typo'd group id errors instead of
        silently creating an empty group (whose committed offsets nobody
        would ever read)."""
        g = self.groups.get(group_id)
        if g is None:
            raise KafkaBrokerError(f"unknown group: {group_id!r}")
        return g

    def _rebalance(self, g: Group) -> None:
        """Range assignment, deterministic: for each topic, contiguous
        partition spans over the topic's subscribers sorted by member id
        (the classic RangeAssignor; floor+remainder split)."""
        g.generation += 1
        g.assignments = {m: [] for m in g.members}
        topics = sorted({t for ts in g.members.values() for t in ts})
        for topic in topics:
            subs = sorted(m for m, ts in g.members.items() if topic in ts)
            if not subs or topic not in self.topics:
                continue
            n_parts = len(self.topics[topic].partitions)
            base, extra = divmod(n_parts, len(subs))
            start = 0
            for i, m in enumerate(subs):
                count = base + (1 if i < extra else 0)
                g.assignments[m].extend(
                    (topic, p) for p in range(start, start + count)
                )
                start += count

    def join_group(
        self, group_id: str, member_id: Optional[str], topics: List[str]
    ) -> Tuple[str, int, List[Tuple[str, int]]]:
        """Add (or re-subscribe) a member; returns (member_id, generation,
        this member's assignment). Every join triggers a rebalance, as in
        the eager group protocol."""
        for t in topics:
            self._topic(t)  # unknown topics fail the join loudly
        g = self._group(group_id)
        if member_id is not None and g.members.get(member_id) == list(topics):
            # rejoin with an unchanged subscription: answer from the
            # current generation instead of bumping it — the wire tier's
            # heartbeat-triggered rejoins (REBALANCE_IN_PROGRESS -> Join/
            # Sync) must converge, not storm every other member forever
            return member_id, g.generation, g.assignments.get(member_id, [])
        if member_id is None:
            member_id = f"member-{g.next_member}"
            g.next_member += 1
        g.members[member_id] = list(topics)
        self._rebalance(g)
        return member_id, g.generation, g.assignments[member_id]

    def leave_group(self, group_id: str, member_id: str) -> None:
        g = self._group_lookup(group_id)
        if member_id in g.members:
            del g.members[member_id]
            self._rebalance(g)

    def group_state(
        self, group_id: str, member_id: str
    ) -> Tuple[int, List[Tuple[str, int]]]:
        """Heartbeat: (current generation, this member's assignment) —
        consumers compare generations to detect a rebalance."""
        g = self._group_lookup(group_id)
        if member_id not in g.members:
            raise KafkaBrokerError(
                f"unknown member {member_id!r} in group {group_id!r}"
            )
        return g.generation, g.assignments.get(member_id, [])

    def commit_offsets(
        self,
        group_id: str,
        offsets: List[Tuple[str, int, int]],
        generation: Optional[int] = None,
    ) -> None:
        """Commit offsets, fenced by generation: a commit stamped with a
        generation below the group's current one is a zombie — a member
        still acting on an assignment a later rebalance revoked — and is
        rejected (real Kafka's ILLEGAL_GENERATION), because applying it
        could roll a partition's committed offset backward past the new
        owner's commits. ``generation=None`` (legacy callers, simple
        tooling) skips the fence."""
        g = self._group_lookup(group_id)
        if generation is not None and generation < g.generation:
            raise KafkaBrokerError(
                f"ILLEGAL_GENERATION: commit for group {group_id!r} carries "
                f"generation {generation} < current {g.generation} (zombie "
                "member — rejoin before committing)"
            )
        for topic, partition, offset in offsets:
            self._partition(topic, partition)  # validate
            g.committed[(topic, partition)] = offset

    def committed_offsets(
        self, group_id: str, tps: List[Tuple[str, int]]
    ) -> List[Tuple[str, int, Optional[int]]]:
        g = self._group_lookup(group_id)
        return [(t, p, g.committed.get((t, p))) for t, p in tps]
