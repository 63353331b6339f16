# The benchmark's plain reference: a frozen copy of madsim_tpu_torch/models/etcd.py, run on the CPU.
# A change to the program's semantics reaches it only through a change to the benchmark.
"""etcd KV + lease service as a batched workload (counterpart of
``madsim_tpu/models/etcd.py``, BASELINE config #2).

One etcd server and ``num_clients`` clients per seed: a revisioned KV
store with leases, client keepalive chains and lease-expiry key
deletion, under client-link partitions. Every mutation bumps the
revision; a lease whose TTL lapses without a keepalive is expired and
its keys deleted. Two online checkers latch ``violation``: revision
monotonicity as each client sees it (``bug_rev_regress`` breaks it) and
a GET never observing a key whose lease expired more than a grace margin
ago (``bug_skip_expiry`` breaks it). ``bug_stale_read`` serves GETs the
value from before the key's latest mutation: the online checkers cannot
see it, the history oracle can (``hist_slots > 0`` records the client
ops on the non-lease keys).

Every handler takes the whole seed batch, as ``models/raft.py`` does:
``w`` is an ``EtcdState`` of ``[S, ...]`` tensors and ``now``/``pay``/
``rand`` are per seed; ``_handle`` evaluates the five branches and
selects per lane (the reference's ``lax.switch`` under ``vmap``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import torch

from ..engine import faults as efaults
from ..engine import net as enet
from ..engine.core import Emits, EngineConfig, Workload
from ..engine.ops import get1, get2, set1, set2
from ..engine.rng import bits, bounded, fold_in, prob_to_q32
from ..oracle.history import OP_GET, OP_PUT, PH_INVOKE, PH_OK
from . import _common

# event kinds
K_OP = 0  # pay = (client,) — client op timer: send a PUT or GET
K_KEEPALIVE = 1  # pay = (client,) — client lease-heartbeat timer
K_MSG = 2  # pay = (dst, mtype, src, a, b, c, opid)
K_EXPIRE = 3  # pay = (lease, gen) — server lease-expiry deadline
K_FAULT = 4  # pay = (action, victim, t_lo, t_hi) — engine/faults.py stream

# message types (slot 6 is the history opid on KV requests and replies,
# -1 on lease traffic)
MT_LEASE = 0  # grant-or-keepalive; a = lease id
MT_PUT = 1  # a = key, b = val, c = lease id (-1 = none)
MT_GET = 2  # a = key
MT_RSP = 3  # a = revision, b = per-client reply sequence, c = op result

PAYLOAD_SLOTS = 7
SERVER = 0

# violation flavors (bitmask latched in ``viol_kind``)
V_REV = 1  # a client observed the revision going backwards
V_EXPIRY = 2  # a GET observed a key whose lease expired long ago

# pending-op table depth per client (in-flight KV ops awaiting replies)
PEND = 8

N_KINDS = 5  # K_OP..K_FAULT

I32 = torch.int32


class EtcdConfig(NamedTuple):
    """Static sweep parameters (the reference's fields and defaults)."""

    num_clients: int = 2
    num_keys: int = 8
    ttl_ns: int = 1_000_000_000
    # client cadences
    keepalive_lo_ns: int = 200_000_000
    keepalive_hi_ns: int = 400_000_000
    op_lo_ns: int = 50_000_000
    op_hi_ns: int = 150_000_000
    # legacy client-partition shorthand; `faults` overrides all four
    partitions: int = 2
    part_window_ns: int = 3_000_000_000
    part_lo_ns: int = 500_000_000
    part_hi_ns: int = 2_000_000_000
    # expiry-check grace: absorbs dispatch jitter (>> 100 ns, << ttl)
    grace_ns: int = 1_000_000
    # network model
    loss_q32: int = prob_to_q32(0.01)
    lat_lo_ns: int = 1_000_000
    lat_hi_ns: int = 10_000_000
    buggify_q32: int = 0
    # deliberate bugs for checker validation
    bug_skip_expiry: bool = False  # expiry handler does nothing
    bug_rev_regress: bool = False  # expiry decrements the revision
    bug_stale_read: bool = False  # GETs serve the pre-mutation value
    # operation-history rows per seed; 0 = recording off
    hist_slots: int = 0
    # a FaultSpec campaign; None derives a client-partition spec from the
    # legacy fields
    faults: Optional[efaults.FaultSpec] = None

    @property
    def num_nodes(self) -> int:
        return 1 + self.num_clients


def fault_spec(cfg: EtcdConfig):
    """``cfg.faults`` verbatim, or the legacy partition fields lifted into
    a FaultSpec whose partition group is the client nodes (1..N)."""
    if cfg.faults is not None:
        return cfg.faults
    return efaults.FaultSpec(
        partitions=cfg.partitions,
        part_window_ns=cfg.part_window_ns,
        part_lo_ns=cfg.part_lo_ns,
        part_hi_ns=cfg.part_hi_ns,
        part_group=(1, -1),
    )


class EtcdState(NamedTuple):
    # server KV [S, K]
    kv_present: torch.Tensor  # bool
    kv_val: torch.Tensor  # int32
    kv_mod_rev: torch.Tensor  # int32
    kv_lease: torch.Tensor  # int32 (-1 = none)
    # pre-mutation shadow of each key (bug_stale_read serves from these)
    kv_prev_present: torch.Tensor  # bool
    kv_prev_val: torch.Tensor  # int32
    rev: torch.Tensor  # int32[S] server revision
    # leases [S, NC] (one slot per client)
    lease_on: torch.Tensor  # bool
    lease_exp: torch.Tensor  # int64
    lease_gen: torch.Tensor  # int32
    rsp_seq: torch.Tensor  # int32[S, NC] replies sent to each client
    # clients [S, NC]
    seen_rev: torch.Tensor  # int32 revision of the newest-sequenced reply
    seen_seq: torch.Tensor  # int32 sequence number of that reply
    # op-history bookkeeping: opid allocator and pending-op table
    next_opid: torch.Tensor  # int32[S, NC]
    pend_id: torch.Tensor  # int32[S, NC, PEND] opid in this slot (-1 = free)
    pend_op: torch.Tensor  # int32[S, NC, PEND] OP_PUT / OP_GET
    pend_key: torch.Tensor  # int32[S, NC, PEND]
    pend_val: torch.Tensor  # int32[S, NC, PEND] PUT value (0 for GET)
    fstate: efaults.FaultState
    links: enet.LinkState
    # sweep outputs [S]
    violation: torch.Tensor  # bool
    viol_kind: torch.Tensor  # int32 flavor bitmask (V_REV | V_EXPIRY)
    vio_rev: torch.Tensor  # bool
    vio_expiry: torch.Tensor  # bool
    puts: torch.Tensor  # int32
    gets: torch.Tensor  # int32
    keepalives: torch.Tensor  # int32 (server-processed)
    grants: torch.Tensor  # int32 (keepalives that (re)granted)
    expiries: torch.Tensor  # int32 (leases actually expired)
    keys_expired: torch.Tensor  # int32 (keys deleted by expiry)
    parts: torch.Tensor  # int32 partitions applied
    msgs_sent: torch.Tensor  # int32
    msgs_delivered: torch.Tensor  # int32
    frt: object  # () (the program's per-lane fault overrides, leafless here)


def _pay(*vals) -> torch.Tensor:
    return _common.pay(*vals, slots=PAYLOAD_SLOTS)


def _emits2(like: torch.Tensor, slot1, slot2) -> Emits:
    """Two-slot Emits (this model never broadcasts); each slot is
    ``(time, kind, pay, enable)`` or None."""
    return _common.pack_extras(PAYLOAD_SLOTS, like.shape[0], like.device, slot1, slot2)


def _node(v, like: torch.Tensor) -> torch.Tensor:
    """A per-seed int32 node id (a python int broadcast over the batch)."""
    return torch.full_like(like, v, dtype=I32)


# -- event handlers ----------------------------------------------------------


def _on_op_timer(cfg: EtcdConfig, w: EtcdState, now, pay, rand):
    """Client c sends a PUT (own key with its lease, or a shared key) or a
    GET of a random key, then re-arms; a crashed or paused client's
    timer keeps ticking but sends nothing."""
    c = pay[:, 0]
    node = c + 1
    server = _node(SERVER, c)
    can_send = get1(efaults.up(w.fstate), node)
    t, deliver = enet.route(w.links, now, node, server, rand[:, 0], rand[:, 1])
    kind_draw = rand[:, 2]
    key_draw = bounded(rand[:, 3], 0, cfg.num_keys).to(I32)
    is_put = (kind_draw & 1) == 0
    own_key = (kind_draw & 2) == 0
    put_key = torch.where(own_key, c, key_draw)
    put_lease = torch.where(own_key, c, -1)
    val = (rand[:, 4] >> 1).to(I32)
    # every request that enters the network claims the client's next
    # opid and parks (op, key, input) in the pending table
    sent = can_send & deliver
    opid = get1(w.next_opid, c)
    slot = opid % PEND
    op_code = torch.where(is_put, OP_PUT, OP_GET).to(I32)
    op_key = torch.where(is_put, put_key, key_draw)
    op_val = torch.where(is_put, val, 0)
    msg = torch.where(
        is_put[:, None],
        _pay(SERVER, MT_PUT, node, put_key, val, put_lease, opid),
        _pay(SERVER, MT_GET, node, key_draw, 0, 0, opid),
    )
    interval = efaults.skewed_delay(
        fault_spec(cfg), w.fstate, node,
        bounded(rand[:, 5], cfg.op_lo_ns, cfg.op_hi_ns),
    )
    emits = _emits2(
        c,
        (t, K_MSG, msg, sent),
        (now + interval, K_OP, _pay(c), True),
    )
    w2 = w._replace(
        next_opid=set1(w.next_opid, c, opid + 1, sent),
        pend_id=set2(w.pend_id, c, slot, opid, sent),
        pend_op=set2(w.pend_op, c, slot, op_code, sent),
        pend_key=set2(w.pend_key, c, slot, op_key, sent),
        pend_val=set2(w.pend_val, c, slot, op_val, sent),
        msgs_sent=w.msgs_sent + can_send.to(I32),
        msgs_delivered=w.msgs_delivered + sent.to(I32),
    )
    return w2, emits


def _on_keepalive_timer(cfg: EtcdConfig, w: EtcdState, now, pay, rand):
    """Client c heartbeats its lease and re-arms; a crashed or paused
    client sends nothing, so its lease expires."""
    c = pay[:, 0]
    node = c + 1
    can_send = get1(efaults.up(w.fstate), node)
    t, deliver = enet.route(w.links, now, node, _node(SERVER, c), rand[:, 0], rand[:, 1])
    interval = efaults.skewed_delay(
        fault_spec(cfg), w.fstate, node,
        bounded(rand[:, 2], cfg.keepalive_lo_ns, cfg.keepalive_hi_ns),
    )
    # opid -1: lease traffic can never alias a pending KV op's completion
    emits = _emits2(
        c,
        (t, K_MSG, _pay(SERVER, MT_LEASE, node, c, 0, 0, -1), can_send & deliver),
        (now + interval, K_KEEPALIVE, _pay(c), True),
    )
    w2 = w._replace(
        msgs_sent=w.msgs_sent + can_send.to(I32),
        msgs_delivered=w.msgs_delivered + (can_send & deliver).to(I32),
    )
    return w2, emits


def _on_msg(cfg: EtcdConfig, w: EtcdState, now, pay, rand):
    dst, mtype, src, a, b, c_ = (pay[:, i] for i in range(6))
    opid = pay[:, 6]
    nc = cfg.num_clients
    up = efaults.up(w.fstate)
    at_server = (dst == SERVER) & up[:, SERVER]

    # -- server: LEASE (grant-or-keepalive) — reset the countdown, bump
    # the generation, schedule a fresh expiry deadline on the server's
    # (possibly skewed) clock
    is_lease = at_server & (mtype == MT_LEASE)
    lease = a
    was_on = get1(w.lease_on, lease)
    new_gen = get1(w.lease_gen, lease) + 1
    new_exp = now + efaults.skewed_delay(
        fault_spec(cfg), w.fstate, _node(SERVER, dst), cfg.ttl_ns
    )
    lease_on2 = set1(w.lease_on, lease, True, is_lease)
    lease_exp2 = set1(w.lease_exp, lease, new_exp, is_lease)
    lease_gen2 = set1(w.lease_gen, lease, new_gen, is_lease)

    # -- server: PUT — one revision per mutation; a PUT attaching a lease
    # that is not live is rejected (grant must precede attach)
    is_put = at_server & (mtype == MT_PUT)
    key, val, put_lease = a, b, c_
    safe_put_lease = torch.clamp(put_lease, 0, nc - 1)
    lease_live = (put_lease < 0) | get1(lease_on2, safe_put_lease)
    do_put = is_put & lease_live
    rev2 = torch.where(do_put, w.rev + 1, w.rev)
    # shadow the pre-mutation value before overwriting
    kv_prev_present2 = set1(w.kv_prev_present, key, get1(w.kv_present, key), do_put)
    kv_prev_val2 = set1(w.kv_prev_val, key, get1(w.kv_val, key), do_put)
    kv_present2 = set1(w.kv_present, key, True, do_put)
    kv_val2 = set1(w.kv_val, key, val, do_put)
    kv_mod_rev2 = set1(w.kv_mod_rev, key, rev2, do_put)
    kv_lease2 = set1(w.kv_lease, key, put_lease, do_put)

    # -- server: GET — the expiry checker: the key must not carry a lease
    # that expired more than grace_ns ago
    is_get = at_server & (mtype == MT_GET)
    g_present = get1(kv_present2, a)
    g_lease = get1(kv_lease2, a)
    has_lease = g_lease >= 0
    safe_lease = torch.clamp(g_lease, 0, nc - 1)
    g_exp = get1(lease_exp2, safe_lease)
    g_on = get1(lease_on2, safe_lease)
    stale = is_get & g_present & has_lease & (~g_on | (g_exp + cfg.grace_ns < now))

    # -- client: RSP — revision monotonicity in server-send order
    is_rsp = (mtype == MT_RSP) & (dst >= 1) & get1(up, dst)
    client = dst - 1
    newer = is_rsp & (b > get1(w.seen_seq, client))
    regress = newer & (a < get1(w.seen_rev, client))
    seen2 = set1(w.seen_rev, client, a, newer)
    seen_seq2 = set1(w.seen_seq, client, b, newer)

    # the served value; the stale-read bug serves the pre-mutation shadow
    g_val = torch.where(g_present, get1(kv_val2, a), -1)
    if cfg.bug_stale_read:
        g_val = torch.where(get1(kv_prev_present2, a), get1(kv_prev_val2, a), -1)

    # the server replies to every request, stamped with the revision and
    # the per-client sequence number
    rt, rdeliver = enet.route(w.links, now, _node(SERVER, dst), src, rand[:, 0], rand[:, 1])
    is_req = is_lease | is_put | is_get
    req_client = torch.clamp(src - 1, 0, nc - 1)
    next_seq = get1(w.rsp_seq, req_client) + 1
    rsp_seq2 = set1(w.rsp_seq, req_client, next_seq, is_req)
    result = torch.where(is_get, g_val, torch.where(is_put, val, 0))
    reply_opid = torch.where(is_put | is_get, opid, -1)
    reply = _pay(src, MT_RSP, SERVER, rev2, next_seq, result, reply_opid)
    emits = _emits2(
        dst,
        (rt, K_MSG, reply, is_req & rdeliver),
        (new_exp, K_EXPIRE, _pay(lease, new_gen), is_lease),
    )
    w2 = w._replace(
        lease_on=lease_on2,
        lease_exp=lease_exp2,
        lease_gen=lease_gen2,
        rev=rev2,
        kv_present=kv_present2,
        kv_val=kv_val2,
        kv_mod_rev=kv_mod_rev2,
        kv_lease=kv_lease2,
        kv_prev_present=kv_prev_present2,
        kv_prev_val=kv_prev_val2,
        rsp_seq=rsp_seq2,
        seen_rev=seen2,
        seen_seq=seen_seq2,
        vio_expiry=w.vio_expiry | stale,
        vio_rev=w.vio_rev | regress,
        violation=w.violation | stale | regress,
        viol_kind=w.viol_kind | stale.to(I32) * V_EXPIRY | regress.to(I32) * V_REV,
        puts=w.puts + do_put.to(I32),
        gets=w.gets + is_get.to(I32),
        keepalives=w.keepalives + is_lease.to(I32),
        grants=w.grants + (is_lease & ~was_on).to(I32),
        msgs_sent=w.msgs_sent + is_req.to(I32),
        msgs_delivered=w.msgs_delivered + (is_req & rdeliver).to(I32),
    )
    return w2, emits


def _on_expire(cfg: EtcdConfig, w: EtcdState, now, pay, rand):
    """Lease-expiry deadline: if the generation still matches (no
    keepalive since), drop the lease and delete every attached key."""
    lease, gen = pay[:, 0], pay[:, 1]
    valid = get1(w.lease_on, lease) & (gen == get1(w.lease_gen, lease))
    if cfg.bug_skip_expiry:
        valid = torch.zeros_like(valid)
    attached = w.kv_present & (w.kv_lease == lease[:, None])
    gone = attached & valid[:, None]
    n_del = gone.sum(dim=1, dtype=I32)
    # one revision per expiry batch
    step = -1 if cfg.bug_rev_regress else 1
    rev2 = torch.where(valid & (n_del > 0), w.rev + step, w.rev)
    w2 = w._replace(
        lease_on=set1(w.lease_on, lease, False, valid),
        kv_present=w.kv_present & ~gone,
        rev=rev2,
        expiries=w.expiries + valid.to(I32),
        keys_expired=w.keys_expired + n_del,
    )
    return w2, _emits2(lease, None, None)


def _on_fault(cfg: EtcdConfig, w: EtcdState, now, pay, rand):
    """One event of the compiled fault campaign: the shared interpreter
    handles the refcounted clog/heal, liveness and pause masks and the
    latency/loss bursts; this model has no per-node volatile state."""
    action, victim = pay[:, 0], pay[:, 1]
    base = efaults.NetBase(cfg.lat_lo_ns, cfg.lat_hi_ns, cfg.loss_q32)
    links2, f2, _edges = efaults.on_event(fault_spec(cfg), base, w.links, w.fstate, action, victim)
    part_like = (
        (action == efaults.F_PART) | (action == efaults.F_PART_IN)
        | (action == efaults.F_PART_OUT)
    )
    w2 = w._replace(links=links2, fstate=f2, parts=w.parts + part_like.to(I32))
    return w2, _emits2(action, None, None)


_BRANCHES = (_on_op_timer, _on_keepalive_timer, _on_msg, _on_expire, _on_fault)


def _handle(cfg: EtcdConfig, w: EtcdState, now, kind, pay, rand):
    return _common.switch(kind, [partial(br, cfg) for br in _BRANCHES], w, now, pay, rand)


def _probe(w: EtcdState):
    """Violation-flavor bitmask (recorded per step by ``run_traced``)."""
    return w.viol_kind


def cover_bits(cfg: EtcdConfig) -> int:
    """One bit per (event kind, node, facet) plus one per violation
    flavor; the facet is the message type for K_MSG and the fault action
    for K_FAULT, 0 otherwise."""
    return N_KINDS * cfg.num_nodes * 4 + 2


def _cover(cfg: EtcdConfig, wb: EtcdState, wa: EtcdState, now, kind, pay):
    """Each dispatched event's coverage bit, or a newly latched violation
    flavor's bit."""
    node = torch.where(kind == K_FAULT, pay[:, 1], pay[:, 0])
    node = torch.clamp(node, 0, cfg.num_nodes - 1)
    facet = torch.where(
        kind == K_MSG,
        torch.clamp(pay[:, 1], 0, 3),
        torch.where(kind == K_FAULT, torch.clamp(pay[:, 0], 0, 3), 0),
    )
    bit = (kind * cfg.num_nodes + node) * 4 + facet
    base = N_KINDS * cfg.num_nodes * 4
    new_viol = wa.viol_kind & ~wb.viol_kind
    flavor = base + ((new_viol & V_REV) == 0).to(I32)
    return torch.where(new_viol != 0, flavor, bit)


def _record(cfg: EtcdConfig, wb: EtcdState, wa: EtcdState, now, kind, pay):
    """Each dispatched event's op-history row (at most one): a K_OP timer
    that put a request on the wire writes the op's INVOKE row, and a
    delivered MT_RSP whose echoed opid still matches its pending slot
    writes the OK row. Only ops on the non-lease keys [num_clients,
    num_keys) are recorded."""
    nc = cfg.num_clients

    # invoke side: the op timer bumped this client's opid allocator
    c = torch.clamp(pay[:, 0], 0, nc - 1)
    inv_opid = get1(wb.next_opid, c)
    sent = (kind == K_OP) & (get1(wa.next_opid, c) > inv_opid)
    slot = inv_opid % PEND
    inv_op = get2(wa.pend_op, c, slot)
    inv_key = get2(wa.pend_key, c, slot)
    inv_val = get2(wa.pend_val, c, slot)
    inv_en = sent & (inv_key >= nc)

    # completion side: a delivered KV reply matching its pending slot
    dst, mtype, result, opid = pay[:, 0], pay[:, 1], pay[:, 5], pay[:, 6]
    rc = torch.clamp(dst - 1, 0, nc - 1)
    is_rsp = (
        (kind == K_MSG)
        & (mtype == MT_RSP)
        & (dst >= 1)
        & get1(efaults.up(wb.fstate), torch.clamp(dst, 0, cfg.num_nodes - 1))
        & (opid >= 0)
    )
    rslot = torch.clamp(opid, 0, 2**30) % PEND
    rsp_op = get2(wb.pend_op, rc, rslot)
    rsp_key = get2(wb.pend_key, rc, rslot)
    matched = is_rsp & (get2(wb.pend_id, rc, rslot) == opid)
    ok_en = matched & (rsp_key >= nc)

    def col(inv, ok):
        return torch.where(inv_en, inv.to(I32), ok.to(I32))

    rec = torch.stack(
        [
            col(c, rc),
            col(inv_op * 2 + PH_INVOKE, rsp_op * 2 + PH_OK),
            col(inv_key, rsp_key),
            col(inv_val, result),
            col(inv_opid, opid),
        ],
        dim=1,
    )
    return rec, inv_en | ok_en


def _init(cfg: EtcdConfig, key: torch.Tensor):
    """Batched initial state and event set from key words ``[S, 2]``."""
    nc = cfg.num_clients
    if cfg.num_keys < nc:
        raise ValueError("num_keys must cover one lease key per client")
    s, dev = key.shape[0], key.device
    # init draws live in their own counter namespace (0x7FFF_FFFF)
    rand = bits(fold_in(key, 0x7FFF_FFFF), 2 * nc)
    nn, nk = cfg.num_nodes, cfg.num_keys

    def z(shape, dtype, fill=0):
        return torch.full((s,) + shape, fill, dtype=dtype, device=dev)

    w = EtcdState(
        kv_present=z((nk,), torch.bool),
        kv_val=z((nk,), I32),
        kv_mod_rev=z((nk,), I32),
        kv_lease=z((nk,), I32, -1),
        kv_prev_present=z((nk,), torch.bool),
        kv_prev_val=z((nk,), I32),
        rev=z((), I32),
        lease_on=z((nc,), torch.bool),
        lease_exp=z((nc,), torch.int64),
        lease_gen=z((nc,), I32),
        rsp_seq=z((nc,), I32),
        seen_rev=z((nc,), I32),
        seen_seq=z((nc,), I32),
        next_opid=z((nc,), I32),
        pend_id=z((nc, PEND), I32, -1),
        pend_op=z((nc, PEND), I32),
        pend_key=z((nc, PEND), I32),
        pend_val=z((nc, PEND), I32),
        fstate=efaults.init_state(s, nn, device=dev),
        links=enet.make(
            s, nn, cfg.loss_q32, cfg.lat_lo_ns, cfg.lat_hi_ns, cfg.buggify_q32, device=dev
        ),
        violation=z((), torch.bool),
        viol_kind=z((), I32),
        vio_rev=z((), torch.bool),
        vio_expiry=z((), torch.bool),
        puts=z((), I32),
        gets=z((), I32),
        keepalives=z((), I32),
        grants=z((), I32),
        expiries=z((), I32),
        keys_expired=z((), I32),
        parts=z((), I32),
        msgs_sent=z((), I32),
        msgs_delivered=z((), I32),
        frt=(),
    )
    # per client: the keepalive chain starts early (its first heartbeat
    # grants the lease), then the op timer
    times, kinds, pays = [], [], []
    for c in range(nc):
        times.append(bounded(rand[:, 2 * c], 0, 50_000_000))
        kinds.append(K_KEEPALIVE)
        times.append(bounded(rand[:, 2 * c + 1], cfg.op_lo_ns, cfg.op_hi_ns))
        kinds.append(K_OP)
        pays += [_pay(z((), I32, c))] * 2
    fe = efaults.compile_device(fault_spec(cfg), nn, key, K_FAULT, PAYLOAD_SLOTS)
    return w, Emits(
        times=torch.cat([torch.stack(times, dim=1), fe.times], dim=1),
        kinds=torch.cat(
            [torch.tensor(kinds, dtype=I32, device=dev).expand(s, -1), fe.kinds], dim=1
        ),
        pays=torch.cat([torch.stack(pays, dim=1), fe.pays], dim=1),
        enables=torch.cat(
            [torch.ones((s, 2 * nc), dtype=torch.bool, device=dev), fe.enables], dim=1
        ),
    )


def history_spec():
    """The sequential spec this model's histories check against
    (``oracle.specs.KVSpec``), also the key of its device screen."""
    from ..oracle.specs import KVSpec

    return KVSpec()


@_common.memoized_workload(EtcdConfig)
def workload(cfg: EtcdConfig = None) -> Workload:
    """The engine Workload for an etcd sweep configuration (memoized)."""
    return Workload(
        init=partial(_init, cfg),
        handle=partial(_handle, cfg),
        num_rand=6,
        payload_slots=PAYLOAD_SLOTS,
        max_emits=2,
        probe=_probe,
        cover=partial(_cover, cfg),
        cover_bits=cover_bits(cfg),
        record=partial(_record, cfg) if cfg.hist_slots > 0 else None,
        hist_slots=cfg.hist_slots,
    )


def engine_config(cfg: EtcdConfig = EtcdConfig(), **overrides) -> EngineConfig:
    """Engine parameters (the reference's queue sizing: 2 timer chains,
    at most a request and a reply per client, the stale expiry deadlines
    ``ttl / keepalive_lo + 1`` per lease, and the fault plan)."""
    stale_expiries = cfg.ttl_ns // cfg.keepalive_lo_ns + 1
    defaults = dict(
        queue_capacity=max(
            48,
            cfg.num_clients * (4 + stale_expiries) + efaults.num_events(fault_spec(cfg)) + 8,
        ),
        time_limit_ns=5_000_000_000,
        max_steps=200_000,
    )
    defaults.update(overrides)
    return EngineConfig(**defaults)
