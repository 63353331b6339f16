"""Seeded differential fuzz for the Kafka wire: one random operation mix
(produce / fetch / list-offsets / group join / heartbeat / commit /
offset-fetch, with a mid-run rebalance and a late leave) applied BOTH
through the genuine wire codec (a :class:`~madsim_tpu_torch.kafka.probe.
ProbeClient` over any transport) and directly to a mirrored in-process
:class:`~madsim_tpu_torch.kafka.broker.Broker`; every per-op result must agree.

Per-seed, the request versions themselves are drawn from the advertised
matrix (``SUPPORTED_APIS``), so the fuzz sweeps the version-gated field
layouts, not just one encoding. The wire-side results also fold into a
SHA-256 digest, a pure function of the seed, so a report of per-seed
digests is byte-diffed across processes and against the reference
package's (``chip_smoke.py`` holds seeds 0-49 on loopback and 1-5 over
TCP to ``data/kafka_fuzz.json``).
"""

from __future__ import annotations

import hashlib
import random
from typing import Dict, List, Optional, Tuple

from .broker import Broker, KafkaBrokerError
from .probe import ProbeClient
from .wire import (
    ERR_GROUP_ID_NOT_FOUND,
    ERR_ILLEGAL_GENERATION,
    ERR_NONE,
    ERR_REBALANCE_IN_PROGRESS,
    ERR_UNKNOWN_MEMBER_ID,
    ERR_UNKNOWN_TOPIC_OR_PARTITION,
)

TOPIC = "fz"
GROUP = "fz-group"


def _expected_heartbeat(mirror: Broker, group: str, member: str,
                        generation: int) -> int:
    """The coordinator fence, computed from the mirror's state — what the
    wire server must answer for (group, member, generation)."""
    g = mirror.groups.get(group)
    if g is None:
        return ERR_GROUP_ID_NOT_FOUND
    if member not in g.members:
        return ERR_UNKNOWN_MEMBER_ID
    if generation != g.generation:
        return ERR_REBALANCE_IN_PROGRESS
    return ERR_NONE


def _expected_commit(mirror: Broker, group: str, tpo, gen) -> int:
    try:
        mirror.commit_offsets(group, [tpo], gen)
        return ERR_NONE
    except KafkaBrokerError as e:
        msg = str(e)
        if "ILLEGAL_GENERATION" in msg:
            return ERR_ILLEGAL_GENERATION
        if "unknown group" in msg:
            return ERR_GROUP_ID_NOT_FOUND
        return ERR_UNKNOWN_TOPIC_OR_PARTITION


async def fuzz_seed(seed: int, client: ProbeClient, ops: int = 40) -> str:
    """Run one seed's op mix through ``client`` (bound to a FRESH
    wire-served broker) and a fresh mirror broker; assert equality per
    op; return the wire-side result digest (hex)."""
    rng = random.Random(seed)
    mirror = Broker()
    acc = hashlib.sha256()

    def note(tag: str, value) -> None:
        acc.update(f"{tag}:{value!r};".encode())

    # per-seed version picks from the advertised matrix
    pv = rng.choice([3, 5, 7])
    fv = rng.choice([4, 7, 10])
    lv = rng.choice([1, 2, 4, 5])
    jv = rng.choice([0, 2, 5])
    sv = rng.choice([0, 1, 3])
    hv = rng.choice([0, 1, 4])
    cv = rng.choice([2, 3, 5])
    ofv = rng.choice([1, 3, 5])
    note("versions", (pv, fv, lv, jv, sv, hv, cv, ofv))

    # -- setup: topic + two group members on both sides ---------------------
    nparts = rng.randrange(1, 4)
    out = await client.create_topics([(TOPIC, nparts)],
                                     ver=rng.choice([0, 1, 2, 4]))
    assert out[0][1] == ERR_NONE, out
    mirror.create_topic(TOPIC, nparts)
    note("topic", nparts)

    members: Dict[str, int] = {}  # member id -> generation it last adopted

    async def join(member_id: str = "") -> str:
        err, gen, member, _leader, _meta = await client.join_group(
            GROUP, member_id, [TOPIC], ver=jv
        )
        assert err == ERR_NONE, (seed, err)
        err, assignment = await client.sync_group(GROUP, gen, member, ver=sv)
        assert err == ERR_NONE, (seed, err)
        m_member, m_gen, m_assigned = mirror.join_group(
            GROUP, member_id or None, [TOPIC]
        )
        assert (member, gen) == (m_member, m_gen), (
            seed, member, gen, m_member, m_gen
        )
        assert sorted(assignment) == sorted(m_assigned), (
            seed, assignment, m_assigned
        )
        members[member] = gen
        note("join", (member, gen, sorted(assignment)))
        return member

    m0 = await join()
    m1 = await join()
    members[m0] = members[m1]  # both adopt the 2-member generation
    # keep the wire server's view of m0 in step too (rejoin, no bump)
    await join(m0)

    high: Dict[int, int] = {p: 0 for p in range(nparts)}
    seq = 0
    third: Optional[str] = None

    for step in range(ops):
        if step == ops // 2 and third is None:
            third = await join()  # mid-run rebalance
            continue
        if third is not None and step == (3 * ops) // 4:
            err = await client.leave_group(GROUP, third,
                                           ver=rng.choice([0, 1, 3]))
            assert err == ERR_NONE, (seed, err)
            mirror.leave_group(GROUP, third)
            members.pop(third, None)
            note("leave", third)
            third = None
            continue

        op = rng.choice(
            ["produce", "produce", "produce", "fetch", "fetch",
             "list_offsets", "heartbeat", "commit", "offset_fetch"]
        )
        if op == "produce":
            p = rng.randrange(nparts)
            key = None if rng.random() < 0.4 else f"k{rng.randrange(6)}".encode()
            val = f"v{seq}".encode() * rng.randrange(1, 3)
            ts = 1_000 + seq * 7
            seq += 1
            err, base = await client.produce(TOPIC, p, [(ts, key, val)], ver=pv)
            m_p, m_off = mirror.produce(TOPIC, p, key, val, ts)
            assert err == ERR_NONE and (p, base) == (m_p, m_off), (
                seed, step, err, base, m_off
            )
            high[p] = m_off + 1
            note("produce", (p, base))
        elif op == "fetch":
            p = rng.randrange(nparts)
            offset = rng.randrange(0, high[p] + 2)
            pmax = rng.choice([40, 1_048_576])
            err, got_high, rows = await client.fetch(
                TOPIC, p, offset, partition_max_bytes=pmax, ver=fv
            )
            m_msgs = mirror.fetch(TOPIC, p, offset, 52_428_800, pmax)
            assert err == ERR_NONE and got_high == high[p], (seed, step)
            assert rows == [
                (m.offset, m.timestamp_ms, m.key, m.payload) for m in m_msgs
            ], (seed, step, rows, m_msgs)
            note("fetch", (p, offset, len(rows)))
        elif op == "list_offsets":
            p = rng.randrange(nparts)
            ts = rng.choice([-1, -2, 1_000 + rng.randrange(max(seq, 1)) * 7])
            err, _rts, off = await client.list_offsets(TOPIC, p, ts, ver=lv)
            assert err == ERR_NONE, (seed, step)
            wm = mirror.watermarks(TOPIC, p)
            if ts == -1:
                expect: Optional[int] = wm.high
            elif ts == -2:
                expect = wm.low
            else:
                (_t, _p, expect), = mirror.offsets_for_times([(TOPIC, p, ts)])
            assert off == (-1 if expect is None else expect), (
                seed, step, off, expect
            )
            note("list_offsets", (p, ts, off))
        elif op == "heartbeat":
            member = rng.choice(sorted(members))
            gen = members[member] if rng.random() < 0.8 else members[member] - 1
            err = await client.heartbeat(GROUP, gen, member, ver=hv)
            expect = _expected_heartbeat(mirror, GROUP, member, gen)
            assert err == expect, (seed, step, err, expect)
            if err == ERR_REBALANCE_IN_PROGRESS and rng.random() < 0.7:
                await join(member)  # the eager protocol's rejoin
            note("heartbeat", (member, gen, err))
        elif op == "commit":
            member = rng.choice(sorted(members))
            p = rng.randrange(nparts)
            off = rng.randrange(0, high[p] + 1)
            gen = members[member] if rng.random() < 0.8 else members[member] - 1
            results = await client.offset_commit(
                GROUP, gen, member, [(TOPIC, p, off)], ver=cv
            )
            expect = _expected_commit(mirror, GROUP, (TOPIC, p, off), gen)
            assert results == [(TOPIC, p, expect)], (
                seed, step, results, expect
            )
            note("commit", (member, p, off, results[0][2]))
        else:  # offset_fetch
            tps = [(TOPIC, rng.randrange(nparts))]
            got = await client.offset_fetch(GROUP, tps, ver=ofv)
            expect = mirror.committed_offsets(GROUP, tps)
            assert got == expect, (seed, step, got, expect)
            note("offset_fetch", got)

    # -- final state: every partition's log identical, key for key ----------
    for p in range(nparts):
        err, got_high, rows = await client.fetch(TOPIC, p, 0, ver=fv)
        m_msgs = mirror.fetch(TOPIC, p, 0, 52_428_800, 52_428_800)
        assert err == ERR_NONE and rows == [
            (m.offset, m.timestamp_ms, m.key, m.payload) for m in m_msgs
        ], (seed, p)
        note("final", (p, got_high, len(rows)))

    return acc.hexdigest()
