# The benchmark's plain reference: a frozen copy of madsim_tpu_torch/models/raft.py, run on the CPU.
# A change to the program's semantics reaches it only through a change to the benchmark.
"""Raft (election + log replication) as a batched workload — the MadRaft
sweep (counterpart of ``madsim_tpu/models/raft.py``).

An N-node Raft cluster per seed — leader election with the §5.4.1 vote
restriction, single-entry AppendEntries replication with consistency
checks and next/match-index bookkeeping, commit advancement under the
§5.4.2 current-term rule — with crash/restart faults and per-message
loss and latency. Two safety invariants latch ``violation``: at most one
leader per term, and log matching at commit.

Every handler takes the whole seed batch: ``w`` is a ``RaftState`` of
``[S, ...]`` tensors, ``now``/``pay``/``rand`` are per seed. The
reference's ``lax.switch`` over event kinds runs under ``vmap`` as "all
five branches, select per lane"; ``_handle`` does the same with one
select per state leaf a branch changed.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import torch

from ..engine import faults as efaults
from ..engine import net as enet
from ..engine.core import Emits, EngineConfig, Workload
from ..engine.ops import get1, get2, geti, set1, set2
from ..engine.rng import bits, bounded, fold_in, prob_to_q32
from ..oracle.history import OP_ELECT, PH_INVOKE
from . import _common

# event kinds
K_ELECTION = 0  # pay = (node, tgen)
K_HEARTBEAT = 1  # pay = (node, lepoch)
K_MSG = 2  # pay = (dst, mtype, src, term, a, b, c, d)
K_FAULT = 3  # pay = (action, victim, t_lo, t_hi)
K_CMD = 4  # pay = (target, retries)

# message types
M_REQ_VOTE = 0  # a=last_log_idx, b=last_log_term
M_VOTE_GRANT = 1
M_APPEND = 2  # a=prev_idx, b=prev_term, c=entry_term (0 = heartbeat), d=commit
M_APPEND_RSP = 3  # a=success, b=match_idx

# roles
FOLLOWER = 0
CANDIDATE = 1
LEADER = 2

PAYLOAD_SLOTS = 8

# violation flavors (bitmask latched in ``viol_kind``)
V_ELECTION = 1
V_COMMIT = 2

N_KINDS = 5
N_ROLE_TRANS = 9  # role_before * 3 + role_after

I32 = torch.int32


class RaftConfig(NamedTuple):
    """Static sweep parameters (the reference's fields and defaults)."""

    num_nodes: int = 5
    election_lo_ns: int = 150_000_000
    election_hi_ns: int = 300_000_000
    heartbeat_ns: int = 50_000_000
    commands: int = 8
    cmd_window_ns: int = 4_000_000_000
    cmd_retry_ns: int = 50_000_000
    cmd_max_retries: int = 64
    log_cap: int = 32
    crashes: int = 2
    crash_window_ns: int = 5_000_000_000
    restart_lo_ns: int = 100_000_000
    restart_hi_ns: int = 1_000_000_000
    loss_q32: int = prob_to_q32(0.01)
    lat_lo_ns: int = 1_000_000
    lat_hi_ns: int = 10_000_000
    buggify_q32: int = 0
    history: int = 16
    volatile_state: bool = False
    hist_slots: int = 0
    # a FaultSpec campaign; None derives a crash storm from the fields above
    faults: Optional[efaults.FaultSpec] = None
    event_mix: bool = False


def fault_spec(cfg: RaftConfig):
    """``cfg.faults`` verbatim, or the legacy crash-storm fields."""
    if cfg.faults is not None:
        return cfg.faults
    return efaults.FaultSpec(
        crashes=cfg.crashes,
        crash_window_ns=cfg.crash_window_ns,
        restart_lo_ns=cfg.restart_lo_ns,
        restart_hi_ns=cfg.restart_hi_ns,
    )


def _shadow_nodes(cfg: RaftConfig) -> int:
    """Width of the durability-shadow planes: ``num_nodes`` iff the spec
    can open a slow-disk window, else 0 (the shadow would provably equal
    the live durable state)."""
    return cfg.num_nodes if efaults.can_stall(fault_spec(cfg)) else 0


class RaftState(NamedTuple):
    # per-node Raft state [S, N] (term/voted/log are durable across crashes)
    role: torch.Tensor  # int32
    term: torch.Tensor  # int32
    voted: torch.Tensor  # int32, -1 = none
    votes: torch.Tensor  # uint32 bitmask of granted votes
    fstate: efaults.FaultState
    last_hb: torch.Tensor  # int64
    tgen: torch.Tensor  # int32 election-timer generation
    lepoch: torch.Tensor  # int32 leadership epoch
    log_term: torch.Tensor  # int32[S, N, L]
    log_len: torch.Tensor  # int32[S, N]
    dur_term: torch.Tensor  # int32[S, SN]  (SN = num_nodes or 0)
    dur_voted: torch.Tensor  # int32[S, SN]
    dur_log_term: torch.Tensor  # int32[S, SN, L]
    dur_log_len: torch.Tensor  # int32[S, SN]
    commit: torch.Tensor  # int32[S, N]
    next_idx: torch.Tensor  # int32[S, N, N]
    match_idx: torch.Tensor  # int32[S, N, N]
    links: enet.LinkState
    hist_term: torch.Tensor  # int32[S, H]
    hist_node: torch.Tensor  # int32[S, H]
    hist_valid: torch.Tensor  # bool[S, H]
    hist_pos: torch.Tensor  # int32[S]
    chist_term: torch.Tensor  # int32[S, L]
    chist_set: torch.Tensor  # bool[S, L]
    violation: torch.Tensor  # bool[S]
    viol_kind: torch.Tensor  # int32[S]
    log_overflow: torch.Tensor  # bool[S]
    elections: torch.Tensor  # int32[S]
    commits: torch.Tensor  # int32[S]
    accepted_cmds: torch.Tensor  # int32[S]
    cmd_giveups: torch.Tensor  # int32[S]
    msgs_sent: torch.Tensor  # int32[S]
    msgs_delivered: torch.Tensor  # int32[S]
    frt: object  # () (the program's per-lane fault overrides, leafless here)


def _flag(cond, value: int) -> torch.Tensor:
    """int32 ``value`` where ``cond`` else 0."""
    return cond.to(I32) * value


def _bit(node) -> torch.Tensor:
    """``uint32(1) << node`` as an int64 word (0 for a shift >= 32, like
    XLA)."""
    n = node.to(torch.int64)
    ok = (n >= 0) & (n < 32)
    return torch.where(ok, 1 << n.clamp(0, 31), 0)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _pay(*vals) -> torch.Tensor:
    return _common.pay(*vals, slots=PAYLOAD_SLOTS)


_DISABLED_EXTRA = _common.DISABLED


def _emits(cfg: RaftConfig, bcast, *extras) -> Emits:
    return _common.pack_emits(PAYLOAD_SLOTS, bcast, *extras)


def _no_bcast(cfg: RaftConfig, like: torch.Tensor):
    return _common.no_bcast(like.shape[0], cfg.num_nodes, PAYLOAD_SLOTS, K_MSG, like.device)


def _pays(cfg: RaftConfig, mtype, src, term, a=0, b=0, c=0, d=0) -> torch.Tensor:
    """``[S, N, P]`` message payloads addressed to every node; each field
    is a python scalar, a per-seed ``[S]`` value or a per-destination
    ``[S, N]`` value."""
    n = cfg.num_nodes
    s, dev = src.shape[0], src.device

    def col(v):
        if not isinstance(v, torch.Tensor):
            return torch.full((s, n), v, dtype=I32, device=dev)
        v = v.to(I32)
        return (v[:, None] if v.ndim == 1 else v).expand(s, n)

    dst = torch.arange(n, dtype=I32, device=dev).expand(s, n)
    cols = [dst, col(mtype), col(src), col(term), col(a), col(b), col(c), col(d)]
    return torch.stack(cols, dim=2)


def _broadcast(cfg: RaftConfig, w: RaftState, now, src, rand, enable, pays):
    """Emit slots 0..N-1: one message per destination (self slot
    disabled), each link-tested."""
    n = cfg.num_nodes
    u = rand[:, : 2 * n].reshape(-1, n, 2)
    times, deliver = enet.route_from(w.links, now, src, u[:, :, 0], u[:, :, 1])
    self_slot = torch.arange(n, device=src.device) == src[:, None]
    enables = enable[:, None] & ~self_slot & deliver
    kinds = torch.full_like(pays[:, :, 0], K_MSG)
    sent = _flag(enable, n - 1)
    delivered = enables.sum(dim=1, dtype=I32)
    return (times, kinds, pays, enables), sent, delivered


def _record_election(cfg: RaftConfig, w: RaftState, term, node, won):
    """Online election-safety check: a term may elect at most one leader."""
    dup = (w.hist_valid & (w.hist_term == term[:, None]) & (w.hist_node != node[:, None])).any(dim=1)
    slot = w.hist_pos % cfg.history
    return w._replace(
        violation=w.violation | (won & dup),
        viol_kind=w.viol_kind | _flag(won & dup, V_ELECTION),
        hist_term=set1(w.hist_term, slot, term, won),
        hist_node=set1(w.hist_node, slot, node, won),
        hist_valid=set1(w.hist_valid, slot, True, won),
        hist_pos=torch.where(won, w.hist_pos + 1, w.hist_pos),
        elections=torch.where(won, w.elections + 1, w.elections),
    )


def _advance_commit(cfg: RaftConfig, w: RaftState, node, new_commit, enable):
    """Move ``commit[node]`` to ``new_commit`` and run the log-matching
    checker over the newly committed range."""
    old = get1(w.commit, node)
    new = torch.where(enable, torch.maximum(old, new_commit.to(I32)), old)
    idx = torch.arange(cfg.log_cap, dtype=I32, device=old.device)
    fresh = (idx > old[:, None]) & (idx <= new[:, None])
    my_terms = get1(w.log_term, node)
    mismatch = (fresh & w.chist_set & (w.chist_term != my_terms)).any(dim=1)
    return w._replace(
        commit=set1(w.commit, node, new),
        chist_term=torch.where(fresh & ~w.chist_set, my_terms, w.chist_term),
        chist_set=w.chist_set | fresh,
        violation=w.violation | mismatch,
        viol_kind=w.viol_kind | _flag(mismatch, V_COMMIT),
        commits=w.commits + (new - old).to(I32),
    )


def _append_pays(cfg: RaftConfig, w: RaftState, leader, term) -> torch.Tensor:
    """AppendEntries payloads ``[S, N, P]``: each follower gets the entry
    at its next-index (or a pure heartbeat when there is nothing newer)."""
    nxt = get1(w.next_idx, leader)  # [S, N]
    log_row = get1(w.log_term, leader)  # [S, L]
    prev_idx = nxt - 1
    prev_term = geti(log_row, prev_idx)
    has_entry = nxt <= get1(w.log_len, leader)[:, None]
    safe_nxt = torch.clamp(nxt, max=cfg.log_cap - 1)
    ent_term = torch.where(has_entry, geti(log_row, safe_nxt), 0)
    return _pays(
        cfg, M_APPEND, leader, term, prev_idx, prev_term, ent_term,
        get1(w.commit, leader),
    )


# -- event handlers (each: (w, now, pay, rand) -> (w, Emits)) ---------------


def _on_election_timer(cfg: RaftConfig, w: RaftState, now, pay, rand):
    node, gen = pay[:, 0], pay[:, 1]
    valid = (
        get1(efaults.up(w.fstate), node)
        & (gen == get1(w.tgen, node))
        & (get1(w.role, node) != LEADER)
    )
    # a live leader/candidate signal arrived since this timer was armed?
    recent = (get1(w.last_hb, node) + cfg.election_lo_ns) > now
    starting = valid & ~recent

    new_term = get1(w.term, node) + 1
    w2 = w._replace(
        term=set1(w.term, node, new_term, starting),
        role=set1(w.role, node, CANDIDATE, starting),
        voted=set1(w.voted, node, node, starting),
        votes=set1(w.votes, node, _bit(node), starting),
        last_hb=set1(w.last_hb, node, now, starting),
    )
    last_idx = get1(w.log_len, node)
    last_term = get2(w.log_term, node, last_idx)
    bcast, sent, delivered = _broadcast(
        cfg, w2, now, node, rand, starting,
        _pays(cfg, M_REQ_VOTE, node, new_term, last_idx, last_term),
    )
    # timer arming runs on the node's own (possibly skewed) clock
    timeout = efaults.skewed_delay(
        fault_spec(cfg), w.fstate, node,
        bounded(rand[:, 2 * cfg.num_nodes], cfg.election_lo_ns, cfg.election_hi_ns),
    )
    emits = _emits(
        cfg,
        bcast,
        (now + timeout, K_ELECTION, _pay(node, get1(w.tgen, node)), valid),
        _DISABLED_EXTRA,
    )
    w2 = w2._replace(
        msgs_sent=w2.msgs_sent + sent, msgs_delivered=w2.msgs_delivered + delivered
    )
    return w2, emits


def _on_heartbeat_timer(cfg: RaftConfig, w: RaftState, now, pay, rand):
    node, epoch = pay[:, 0], pay[:, 1]
    valid = (
        get1(efaults.up(w.fstate), node)
        & (get1(w.role, node) == LEADER)
        & (epoch == get1(w.lepoch, node))
    )
    term = get1(w.term, node)
    bcast, sent, delivered = _broadcast(
        cfg, w, now, node, rand, valid, _append_pays(cfg, w, node, term)
    )
    hb = efaults.skewed_delay(
        fault_spec(cfg), w.fstate, node, cfg.heartbeat_ns
    )
    emits = _emits(
        cfg,
        bcast,
        (now + hb, K_HEARTBEAT, _pay(node, epoch), valid),
        _DISABLED_EXTRA,
    )
    w2 = w._replace(
        msgs_sent=w.msgs_sent + sent, msgs_delivered=w.msgs_delivered + delivered
    )
    return w2, emits


def _on_msg(cfg: RaftConfig, w: RaftState, now, pay, rand):
    dst, mtype, src, mterm = pay[:, 0], pay[:, 1], pay[:, 2], pay[:, 3]
    a, b, c, d = pay[:, 4], pay[:, 5], pay[:, 6], pay[:, 7]
    live = get1(efaults.up(w.fstate), dst)
    role_dst = get1(w.role, dst)
    was_leader = live & (role_dst == LEADER)

    # term catch-up (Raft §5.1): any message with a higher term demotes
    term_dst = get1(w.term, dst)
    higher = live & (mterm > term_dst)
    term_d = torch.where(higher, mterm, term_dst)
    role_d = torch.where(higher, FOLLOWER, role_dst)
    voted_d = torch.where(higher, -1, get1(w.voted, dst))

    is_rv = live & (mtype == M_REQ_VOTE)
    is_vg = live & (mtype == M_VOTE_GRANT)
    is_ap = live & (mtype == M_APPEND)
    is_ar = live & (mtype == M_APPEND_RSP)

    log_row = get1(w.log_term, dst)  # [S, L] this node's log terms
    my_len = get1(w.log_len, dst)

    # -- RequestVote (§5.4.1): grant iff same term, not voted for anyone
    # else, and the candidate's log is at least as up to date
    my_last_term = geti(log_row, my_len[:, None])[:, 0]
    log_ok = (b > my_last_term) | ((b == my_last_term) & (a >= my_len))
    grant = is_rv & (mterm == term_d) & ((voted_d == -1) | (voted_d == src)) & log_ok
    voted_d = torch.where(grant, src, voted_d)

    # -- VoteGrant: count iff still candidate in that term
    counted = is_vg & (role_d == CANDIDATE) & (mterm == term_d)
    votes_dst = get1(w.votes, dst).to(torch.int64)
    votes_d = torch.where(counted, votes_dst | _bit(src), votes_dst)
    majority = cfg.num_nodes // 2 + 1
    won = counted & (_popcount32(votes_d) >= majority)
    role_d = torch.where(won, LEADER, role_d)

    # -- AppendEntries: same-term leader signal; consistency-check and
    # append the carried entry; follow the leader's commit
    heard = is_ap & (mterm == term_d)
    role_d = torch.where(heard & (role_d == CANDIDATE), FOLLOWER, role_d)
    prev_idx, prev_term, ent_term, leader_commit = a, b, c, d
    consistent = heard & (prev_idx <= my_len) & (
        geti(log_row, prev_idx[:, None])[:, 0] == prev_term
    )
    has_entry = ent_term > 0
    slot_idx = prev_idx + 1
    can_store = slot_idx < cfg.log_cap
    store = consistent & has_entry & can_store
    overflow = consistent & has_entry & ~can_store
    # §5.3 append rule: an existing same-term entry keeps the suffix; a
    # conflicting entry truncates the log at the new entry's index
    existing_same = (slot_idx <= my_len) & (
        geti(log_row, torch.clamp(slot_idx, max=cfg.log_cap - 1)[:, None])[:, 0] == ent_term
    )
    new_len = torch.where(store, torch.where(existing_same, my_len, slot_idx), my_len)

    lepoch_dst = get1(w.lepoch, dst)
    w2 = w._replace(
        term=set1(w.term, dst, term_d),
        role=set1(w.role, dst, role_d),
        voted=set1(w.voted, dst, voted_d),
        votes=set1(w.votes, dst, votes_d),
        lepoch=set1(w.lepoch, dst, lepoch_dst + 1, won),
        last_hb=set1(w.last_hb, dst, now, heard | grant | won),
        log_term=set2(w.log_term, dst, slot_idx, ent_term, store),
        log_len=set1(w.log_len, dst, new_len),
        log_overflow=w.log_overflow | overflow,
    )
    w2 = _record_election(cfg, w2, term_d, dst, won)
    # follower commit: min(leader_commit, own len) once consistent
    w2 = _advance_commit(
        cfg, w2, dst, torch.minimum(leader_commit, get1(w2.log_len, dst)), consistent
    )

    # -- AppendEntries response (leader side): update next/match, advance
    # commit under the §5.4.2 current-term rule
    rsp_ok = is_ar & (mterm == term_d) & (role_d == LEADER)
    success = a == 1
    old_match = get2(w2.match_idx, dst, src)
    old_next = get2(w2.next_idx, dst, src)
    new_match = torch.where(rsp_ok & success, torch.maximum(old_match, b), old_match)
    new_next = torch.where(
        rsp_ok,
        torch.where(success, new_match + 1, torch.clamp(old_next - 1, min=1)),
        old_next,
    )
    w2 = w2._replace(
        match_idx=set2(w2.match_idx, dst, src, new_match),
        next_idx=set2(w2.next_idx, dst, src, new_next),
    )
    # commit: highest idx replicated on a majority with an entry of the
    # leader's current term
    dev = dst.device
    idxs = torch.arange(cfg.log_cap, dtype=I32, device=dev)
    self_mask = torch.arange(cfg.num_nodes, device=dev) == dst[:, None]  # [S, N]
    match_row = get1(w2.match_idx, dst)  # [S, N]
    # replicas[i] = 1 + #followers with match_idx >= i
    reps = 1 + (
        (match_row[:, None, :] >= idxs[None, :, None]) & ~self_mask[:, None, :]
    ).sum(dim=2, dtype=I32)
    my_len2 = get1(w2.log_len, dst)
    log_row2 = get1(w2.log_term, dst)
    committable = (
        (idxs <= my_len2[:, None])
        & (idxs > get1(w2.commit, dst)[:, None])
        & (reps >= majority)
        & (log_row2 == term_d[:, None])
    )
    best = torch.where(committable, idxs, 0).amax(dim=1)
    w2 = _advance_commit(cfg, w2, dst, best, rsp_ok & (best > 0))

    # a leader demoted by a higher term re-enters the election-timer chain
    demoted = was_leader & (role_d != LEADER)
    tgen_dst = get1(w.tgen, dst)
    tgen_d = torch.where(demoted, tgen_dst + 1, tgen_dst)
    w2 = w2._replace(tgen=set1(w2.tgen, dst, tgen_d))

    # on win: reset leader bookkeeping and broadcast immediate heartbeats
    init_next = get1(w2.log_len, dst) + 1
    w2 = w2._replace(
        next_idx=set1(w2.next_idx, dst, init_next, won),
        match_idx=set1(w2.match_idx, dst, 0, won),
    )
    bcast, sent, delivered = _broadcast(
        cfg, w2, now, dst, rand, won, _append_pays(cfg, w2, dst, term_d)
    )
    # extra slot 1: heartbeat timer (won) | vote reply (grant) | append rsp
    n2 = 2 * cfg.num_nodes
    rt, rdeliver = enet.route(w.links, now, dst, src, rand[:, n2], rand[:, n2 + 1])
    ap_success = consistent.to(I32)
    ap_match = torch.where(
        store, slot_idx, torch.minimum(prev_idx, get1(w2.log_len, dst))
    )
    reply_pay = torch.where(
        grant[:, None],
        _pay(src, M_VOTE_GRANT, dst, mterm),
        _pay(src, M_APPEND_RSP, dst, term_d, ap_success, ap_match),
    )
    attempt_reply = (grant | is_ap) & live
    send_reply = attempt_reply & rdeliver
    hb = efaults.skewed_delay(
        fault_spec(cfg), w.fstate, dst, cfg.heartbeat_ns
    )
    extra_time = torch.where(won, now + hb, rt)
    extra_kind = torch.where(won, K_HEARTBEAT, K_MSG).to(I32)
    extra_pay = torch.where(won[:, None], _pay(dst, get1(w2.lepoch, dst)), reply_pay)
    extra_on = won | (send_reply & ~won)
    # extra slot 2: the demoted ex-leader's fresh election timer
    retimeout = efaults.skewed_delay(
        fault_spec(cfg), w.fstate, dst,
        bounded(rand[:, n2 + 2], cfg.election_lo_ns, cfg.election_hi_ns),
    )
    emits = _emits(
        cfg,
        bcast,
        (extra_time, extra_kind, extra_pay, extra_on),
        (now + retimeout, K_ELECTION, _pay(dst, tgen_d), demoted),
    )
    # sent counts every attempted reply; delivered those that passed
    # the link test
    w2 = w2._replace(
        msgs_sent=w2.msgs_sent + sent + attempt_reply.to(I32),
        msgs_delivered=w2.msgs_delivered + delivered + send_reply.to(I32),
    )
    return w2, emits


def _on_fault(cfg: RaftConfig, w: RaftState, now, pay, rand):
    """One event of the compiled fault campaign: the shared interpreter
    updates liveness/pause masks and links; this adds the Raft
    consequences (volatile resets on crash, timer-chain bumps on
    crash/pause, re-arming on restart/resume, the durability rollback and
    the amnesia wipe)."""
    action, victim = pay[:, 0], pay[:, 1]
    base = efaults.NetBase(cfg.lat_lo_ns, cfg.lat_hi_ns, cfg.loss_q32)
    links2, f2, e = efaults.on_event(
        fault_spec(cfg), base, w.links, w.fstate, action, victim
    )
    crashed, restarted, resumed = e.crashed, e.restarted, e.resumed
    stopped = crashed | e.paused
    revived = restarted | resumed

    rollback = {}
    if _shadow_nodes(cfg):
        rollback = dict(
            term=set1(w.term, victim, get1(w.dur_term, victim), crashed),
            voted=set1(w.voted, victim, get1(w.dur_voted, victim), crashed),
            log_len=set1(w.log_len, victim, get1(w.dur_log_len, victim), crashed),
            log_term=set1(w.log_term, victim, get1(w.dur_log_term, victim), crashed),
        )
    w2 = w._replace(
        links=links2,
        fstate=f2,
        role=set1(w.role, victim, FOLLOWER, crashed | restarted),
        votes=set1(w.votes, victim, 0, crashed),
        commit=set1(w.commit, victim, 0, crashed),
        tgen=set1(w.tgen, victim, get1(w.tgen, victim) + 1, stopped),
        lepoch=set1(w.lepoch, victim, get1(w.lepoch, victim) + 1, stopped),
        last_hb=set1(w.last_hb, victim, now, revived),
        **rollback,
    )
    if cfg.volatile_state:
        # amnesia mode: the "durable" state dies with the process too
        w2 = w2._replace(
            term=set1(w2.term, victim, 0, crashed),
            voted=set1(w2.voted, victim, -1, crashed),
            log_len=set1(w2.log_len, victim, 0, crashed),
            log_term=set1(w2.log_term, victim, 0, crashed),
        )
        if _shadow_nodes(cfg):
            w2 = w2._replace(
                dur_term=set1(w2.dur_term, victim, 0, crashed),
                dur_voted=set1(w2.dur_voted, victim, -1, crashed),
                dur_log_len=set1(w2.dur_log_len, victim, 0, crashed),
                dur_log_term=set1(w2.dur_log_term, victim, 0, crashed),
            )
    timeout = efaults.skewed_delay(
        fault_spec(cfg), f2, victim,
        bounded(rand[:, 0], cfg.election_lo_ns, cfg.election_hi_ns),
    )
    still_leader = get1(w2.role, victim) == LEADER  # only a resumed leader
    hb = efaults.skewed_delay(
        fault_spec(cfg), f2, victim, cfg.heartbeat_ns
    )
    emits = _emits(
        cfg,
        _no_bcast(cfg, victim),
        (now + timeout, K_ELECTION, _pay(victim, get1(w2.tgen, victim)),
         revived & ~still_leader),
        (now + hb, K_HEARTBEAT, _pay(victim, get1(w2.lepoch, victim)),
         resumed & still_leader),
    )
    return w2, emits


def _on_cmd(cfg: RaftConfig, w: RaftState, now, pay, rand):
    """A client command looking for the leader: a live leader with log
    room appends an entry of its term; otherwise retry the next node."""
    target, retries = pay[:, 0], pay[:, 1]
    is_leader = get1(efaults.up(w.fstate), target) & (get1(w.role, target) == LEADER)
    slot = get1(w.log_len, target) + 1
    room = slot < cfg.log_cap
    accept = is_leader & room
    w2 = w._replace(
        log_term=set2(w.log_term, target, slot, get1(w.term, target), accept),
        log_len=set1(w.log_len, target, slot, accept),
        log_overflow=w.log_overflow | (is_leader & ~room),
        accepted_cmds=w.accepted_cmds + accept.to(I32),
    )
    next_target = (target + 1) % cfg.num_nodes
    give_up = ~accept & (retries + 1 >= cfg.cmd_max_retries)
    w2 = w2._replace(cmd_giveups=w2.cmd_giveups + give_up.to(I32))
    emits = _emits(
        cfg,
        _no_bcast(cfg, target),
        (now + cfg.cmd_retry_ns, K_CMD, _pay(next_target, retries + 1),
         ~accept & ~give_up),
        _DISABLED_EXTRA,
    )
    return w2, emits


def cover_bits(cfg: RaftConfig) -> int:
    """One bit per (event kind, node, role transition) plus one bit per
    violation flavor."""
    return N_KINDS * cfg.num_nodes * N_ROLE_TRANS + 2


def _cover(cfg: RaftConfig, wb: RaftState, wa: RaftState, now, kind, pay):
    """Each dispatched event's coverage bit: (kind x node x role
    transition), or a newly latched violation flavor's bit."""
    node = torch.where(kind == K_FAULT, pay[:, 1], pay[:, 0])
    node = torch.clamp(node, 0, cfg.num_nodes - 1)
    trans = get1(wb.role, node) * 3 + get1(wa.role, node)
    bit = (kind * cfg.num_nodes + node) * N_ROLE_TRANS + trans
    base = N_KINDS * cfg.num_nodes * N_ROLE_TRANS
    new_viol = wa.viol_kind & ~wb.viol_kind
    flavor = base + ((new_viol & V_ELECTION) == 0).to(I32)
    return torch.where(new_viol != 0, flavor, bit)


def _probe(w: RaftState):
    """Violation-flavor bitmask (recorded per step by ``run_traced``)."""
    return w.viol_kind


def _record(cfg: RaftConfig, wb: RaftState, wa: RaftState, now, kind, pay):
    """Each won election's OP_ELECT invoke row (client = winner node,
    key = the won term, opid = the global election counter)."""
    won = wa.elections > wb.elections
    node = torch.clamp(pay[:, 0], 0, cfg.num_nodes - 1)
    term = get1(wa.term, node)
    code = torch.full_like(node, OP_ELECT * 2 + PH_INVOKE)
    return torch.stack([node, code, term, node, wb.elections], dim=1), won


_BRANCHES = (_on_election_timer, _on_heartbeat_timer, _on_msg, _on_fault, _on_cmd)


def _handle(cfg: RaftConfig, w: RaftState, now, kind, pay, rand):
    w2, emits = _common.switch(
        kind, [partial(br, cfg) for br in _BRANCHES], w, now, pay, rand
    )
    # durability plane: fsync-on-mutate — after every event each node's
    # synced shadow catches up to the live durable state unless a
    # slow-disk window holds its fsync
    if _shadow_nodes(cfg):
        sync = ~efaults.stalled(w2.fstate)
        w2 = w2._replace(
            dur_term=torch.where(sync, w2.term, w2.dur_term),
            dur_voted=torch.where(sync, w2.voted, w2.dur_voted),
            dur_log_len=torch.where(sync, w2.log_len, w2.dur_log_len),
            dur_log_term=torch.where(sync[:, :, None], w2.log_term, w2.dur_log_term),
        )
    return w2, emits


def _init(cfg: RaftConfig, key: torch.Tensor):
    """Batched initial state and event set from key words ``[S, 2]``."""
    s, dev = key.shape[0], key.device
    n = cfg.num_nodes
    # init draws live in their own counter namespace (0x7FFF_FFFF)
    rand = bits(fold_in(key, 0x7FFF_FFFF), n + 2 * cfg.commands)
    sn = _shadow_nodes(cfg)

    def z(shape, dtype, fill=0):
        return torch.full((s,) + shape, fill, dtype=dtype, device=dev)

    w = RaftState(
        role=z((n,), I32),
        term=z((n,), I32),
        voted=z((n,), I32, -1),
        votes=z((n,), torch.uint32),
        fstate=efaults.init_state(s, n, device=dev),
        last_hb=z((n,), torch.int64),
        tgen=z((n,), I32),
        lepoch=z((n,), I32),
        log_term=z((n, cfg.log_cap), I32),
        log_len=z((n,), I32),
        dur_term=z((sn,), I32),
        dur_voted=z((sn,), I32, -1),
        dur_log_term=z((sn, cfg.log_cap), I32),
        dur_log_len=z((sn,), I32),
        commit=z((n,), I32),
        next_idx=z((n, n), I32, 1),
        match_idx=z((n, n), I32),
        links=enet.make(
            s, n, cfg.loss_q32, cfg.lat_lo_ns, cfg.lat_hi_ns, cfg.buggify_q32,
            device=dev,
        ),
        hist_term=z((cfg.history,), I32),
        hist_node=z((cfg.history,), I32),
        hist_valid=z((cfg.history,), torch.bool),
        hist_pos=z((), I32),
        chist_term=z((cfg.log_cap,), I32),
        chist_set=z((cfg.log_cap,), torch.bool),
        violation=z((), torch.bool),
        viol_kind=z((), I32),
        log_overflow=z((), torch.bool),
        elections=z((), I32),
        commits=z((), I32),
        accepted_cmds=z((), I32),
        cmd_giveups=z((), I32),
        msgs_sent=z((), I32),
        msgs_delivered=z((), I32),
        frt=(),
    )
    # one election timer per node, then the client command plan
    times = [bounded(rand[:, i], cfg.election_lo_ns, cfg.election_hi_ns) for i in range(n)]
    pays = [_pay(z((), I32, i), 0) for i in range(n)]
    for k in range(cfg.commands):
        times.append(bounded(rand[:, n + 2 * k], 0, cfg.cmd_window_ns))
        target = bounded(rand[:, n + 2 * k + 1], 0, n).to(I32)
        pays.append(_pay(target, 0))
    kinds = torch.tensor(
        [K_ELECTION] * n + [K_CMD] * cfg.commands, dtype=I32, device=dev
    ).expand(s, -1)
    # fault campaign: the shared compiler's event stream, spliced in
    fe = efaults.compile_device(
        fault_spec(cfg), n, key, K_FAULT, PAYLOAD_SLOTS
    )
    return w, Emits(
        times=torch.cat([torch.stack(times, dim=1), fe.times], dim=1),
        kinds=torch.cat([kinds, fe.kinds], dim=1),
        pays=torch.cat([torch.stack(pays, dim=1), fe.pays], dim=1),
        enables=torch.cat(
            [torch.ones((s, n + cfg.commands), dtype=torch.bool, device=dev), fe.enables],
            dim=1,
        ),
    )


@_common.memoized_workload(RaftConfig)
def workload(cfg: RaftConfig = None) -> Workload:
    """The engine Workload for a Raft sweep configuration (memoized)."""
    return Workload(
        init=partial(_init, cfg),
        handle=partial(_handle, cfg),
        num_rand=2 * cfg.num_nodes + 3,
        payload_slots=PAYLOAD_SLOTS,
        max_emits=cfg.num_nodes + 2,
        cover=partial(_cover, cfg),
        cover_bits=cover_bits(cfg),
        probe=_probe,
        record=partial(_record, cfg) if cfg.hist_slots > 0 else None,
        hist_slots=cfg.hist_slots,
        event_mix_kinds=N_KINDS if cfg.event_mix else 0,
    )


def engine_config(cfg: RaftConfig = RaftConfig(), **overrides) -> EngineConfig:
    """Engine parameters sized for this workload (the reference's queue
    sizing: ``max(48, 2 N^2 + commands + fault events)``)."""
    defaults = dict(
        queue_capacity=max(
            48,
            2 * cfg.num_nodes * cfg.num_nodes
            + cfg.commands
            + efaults.num_events(fault_spec(cfg)),
        ),
        time_limit_ns=10_000_000_000,
        max_steps=200_000,
    )
    defaults.update(overrides)
    return EngineConfig(**defaults)
