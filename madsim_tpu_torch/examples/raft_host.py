"""Host-tier Raft leader election — the MadRaft-style workload on the
port's Python executor (the port's own copy of ``examples/raft_host.py``).

This is the same workload as ``madsim_tpu_torch.models.raft`` runs on the
device engine, written the way a *user* of the framework writes it:
ordinary async code on simulated nodes with Endpoint messaging,
randomized election timers on virtual time, and supervisor-injected
crash/restarts. It is the host half of the cross-tier replay
(``replay.replay_on_host``) and of the host↔device differential
(``explore.differential.host_outcomes``).

Run directly:  python -m madsim_tpu_torch.examples.raft_host [seed]
"""

from __future__ import annotations

import sys
from typing import Dict, List

import madsim_tpu_torch as ms
from madsim_tpu_torch import faults
from madsim_tpu_torch.net import Endpoint
from madsim_tpu_torch.oracle.history import OP_ELECT, HostRecorder

FOLLOWER, CANDIDATE, LEADER = 0, 1, 2
TAG = 1
PORT = 700

ELECTION_LO = 0.150
ELECTION_HI = 0.300
HEARTBEAT = 0.050
TICK = 0.010  # election-deadline poll granularity


def _ip(i: int) -> str:
    return f"10.0.0.{i + 1}"


class _Node:
    """Per-node volatile election state + message handlers."""

    def __init__(self, i: int, n: int, stats: Dict):
        self.i = i
        self.n = n
        self.stats = stats
        self.role = FOLLOWER
        self.term = 0
        self.voted = -1
        self.votes: set = set()
        self.deadline = ms.time.now_instant() + self._timeout()

    def _timeout(self) -> float:
        """Election timeout as THIS node's (possibly skewed) clock
        measures it: inside a clock-skew window the node's timers
        stretch by num/den — the host half of the device tier's
        ``engine.faults.skewed_delay`` (docs/faults.md gray failures)."""
        num, den = ms.time.node_skew()
        return ms.rand.uniform(ELECTION_LO, ELECTION_HI) * num / den

    def _reset_deadline(self) -> None:
        self.deadline = ms.time.now_instant() + self._timeout()

    async def _broadcast(self, ep: Endpoint, msg: tuple) -> None:
        for j in range(self.n):
            if j != self.i:
                await ep.send_to_raw((_ip(j), PORT), TAG, msg)
                self.stats["msgs"] += 1

    async def _become_leader(self, ep: Endpoint) -> None:
        self.role = LEADER
        self.stats["elections"].append((self.term, self.i))
        rec = self.stats.get("recorder")
        if rec is not None:
            # same row the device model's record hook writes: one
            # OP_ELECT invoke per won election (client = node, key =
            # term) — checkable by oracle.specs.ElectionSpec on either
            # tier (explore/differential.py)
            rec.invoke(client=self.i, op=OP_ELECT, key=self.term, inp=self.i)
        for term, who in self.stats["elections"]:
            if term == self.term and who != self.i:
                self.stats["violations"] += 1
        await self._broadcast(ep, ("ae", self.term, self.i))

    async def handle(self, ep: Endpoint, msg: tuple) -> None:
        kind, mterm, src = msg
        if mterm > self.term:
            self.term, self.role, self.voted = mterm, FOLLOWER, -1
            self.votes = set()
        if kind == "rv":
            if mterm == self.term and self.voted in (-1, src):
                self.voted = src
                self._reset_deadline()
                await ep.send_to_raw((_ip(src), PORT), TAG, ("vg", mterm, self.i))
                self.stats["msgs"] += 1
        elif kind == "vg":
            if self.role == CANDIDATE and mterm == self.term:
                self.votes.add(src)
                if len(self.votes) >= self.n // 2 + 1:
                    await self._become_leader(ep)
        elif kind == "ae":
            if mterm == self.term:
                if self.role == CANDIDATE:
                    self.role = FOLLOWER
                self._reset_deadline()

    async def receiver(self, ep: Endpoint) -> None:
        while True:
            msg, _src = await ep.recv_from_raw(TAG)
            await self.handle(ep, msg)

    async def ticker(self, ep: Endpoint) -> None:
        """Election timer (poll) + leader heartbeats."""
        while True:
            if self.role == LEADER:
                await ms.sleep(HEARTBEAT)
                await self._broadcast(ep, ("ae", self.term, self.i))
            else:
                await ms.sleep(TICK)
                if ms.time.now_instant() >= self.deadline:
                    self.term += 1
                    self.role = CANDIDATE
                    self.voted = self.i
                    self.votes = {self.i}
                    self._reset_deadline()
                    await self._broadcast(ep, ("rv", self.term, self.i))


def _node_init(i: int, n: int, stats: Dict):
    def make():
        async def run():
            node = _Node(i, n, stats)
            ep = await Endpoint.bind((_ip(i), PORT))
            ms.spawn(node.receiver(ep))
            await node.ticker(ep)

        return run()

    return make


async def _supervise(stats: Dict, n: int, crashes: int, sim_seconds: float) -> None:
    h = ms.current_handle()
    nodes: List = [
        h.create_node().name(f"raft-{i}").ip(_ip(i)).init(_node_init(i, n, stats)).build()
        for i in range(n)
    ]
    deadline = ms.time.now_instant() + sim_seconds
    for _ in range(crashes):
        at = ms.rand.uniform(0.0, sim_seconds / 2)
        victim = nodes[ms.rand.gen_range(0, n)]
        await ms.sleep(max(at - ms.time.elapsed(), 0.001))
        h.kill(victim)
        await ms.sleep(ms.rand.uniform(0.1, 1.0))
        h.restart(victim)
    remaining = deadline - ms.time.now_instant()
    if remaining > 0:
        await ms.sleep(remaining)


def _fresh_stats() -> Dict:
    """Run stats + the op-history recorder (oracle.HostRecorder): every
    run emits a checkable election history alongside the counters, so
    the differential harness (explore/differential.py) can check host
    and device histories against the same sequential spec."""
    return {
        "elections": [],
        "violations": 0,
        "msgs": 0,
        "recorder": HostRecorder(),
    }


def _finish_stats(stats: Dict, seed: int) -> Dict:
    stats["seed"] = seed
    stats["leaders_elected"] = len(stats["elections"])
    stats["history"] = stats.pop("recorder").history(seed)
    return stats


def run_seed(
    seed: int, n: int = 5, crashes: int = 1, sim_seconds: float = 3.0
) -> Dict:
    """One complete simulation; returns election stats for the seed."""
    stats = _fresh_stats()
    rt = ms.Runtime(seed=seed)
    rt.block_on(_supervise(stats, n, crashes, sim_seconds))
    return _finish_stats(stats, seed)


async def _supervise_plan(
    stats: Dict, n: int, plan, sim_seconds: float, spec=None
) -> None:
    """Supervisor that applies a *recorded* fault schedule (from a
    device-tier trace or ``faults.compile_host``) instead of drawing its
    own faults — the shared ``faults.apply_schedule``
    supervisor, which mirrors the device tier's edge-gated semantics
    (restarting a live node is a no-op on both tiers)."""
    h = ms.current_handle()
    nodes: List = [
        h.create_node().name(f"raft-{i}").ip(_ip(i)).init(_node_init(i, n, stats)).build()
        for i in range(n)
    ]
    await faults.apply_schedule(plan, nodes, spec=spec)
    remaining = sim_seconds - ms.time.elapsed()
    if remaining > 0:
        await ms.sleep(remaining)


def run_seed_with_plan(
    seed: int, plan, n: int = 5, sim_seconds: float = 3.0, spec=None,
    extend: bool = True,
) -> Dict:
    """One simulation with the recorded faults at the recorded virtual
    times.

    The cross-tier replay target: a device-found seed's fault schedule
    re-applied to this ordinary async implementation, debugger-attachable.
    By default the run extends at least one second past the last planned
    fault so the cluster gets a post-fault observation window even when
    the plan outlives ``sim_seconds``; pass ``extend=False`` to hard-stop
    at ``sim_seconds`` instead (the differential harness does — a matched
    host↔device grid needs matched horizons, and the device tier stops
    at its ``time_limit_ns`` regardless of the schedule). ``spec`` is
    only needed when the schedule contains latency/loss burst or
    clock-skew events.
    """
    stats = _fresh_stats()
    end_s = sim_seconds
    if plan and extend:
        end_s = max(end_s, max(t for t, _, _ in plan) / 1e9 + 1.0)
    elif plan and not extend:
        plan = [e for e in plan if e[0] / 1e9 < sim_seconds]
    rt = ms.Runtime(seed=seed)
    rt.block_on(_supervise_plan(stats, n, plan, end_s, spec=spec))
    return _finish_stats(stats, seed)


def run_seed_with_spec(
    seed: int, spec, campaign_seed: int, n: int = 5, sim_seconds: float = 3.0,
    extend: bool = True,
) -> Dict:
    """One simulation under a declarative fault campaign: the SAME
    ``FaultSpec`` + ``campaign_seed`` a device-tier sweep lane compiles
    (models/raft.py ``fault_spec``), applied to this ordinary async
    implementation — no trace hop needed."""
    plan = faults.compile_host(spec, n, campaign_seed)
    return run_seed_with_plan(
        seed, plan, n=n, sim_seconds=sim_seconds, spec=spec, extend=extend
    )


if __name__ == "__main__":
    seed = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    out = run_seed(seed)
    print(
        f"seed={seed} elections={out['leaders_elected']} "
        f"violations={out['violations']} msgs={out['msgs']}"
    )
