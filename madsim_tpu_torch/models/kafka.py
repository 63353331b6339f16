"""Kafka broker, producers and consumers as a batched workload
(counterpart of ``madsim_tpu/models/kafka.py``, BASELINE config #4).

One broker (node 0) with per-partition append-only logs, a log-end
offset and a durable (flushed) watermark; ``num_producers`` producers
that resend their lowest unacknowledged sequence number until it is
acknowledged; ``num_consumers`` consumers polling from their offset up
to the durable watermark. A broker crash loses every entry past the
watermark; a restart resumes from durable state. Two online checkers
latch ``violation``: no acknowledged message lost at a crash (the
``bug_ack_on_append`` flag acks on append instead of at flush and
breaks it) and the durable watermark never past the log end.
``hist_slots > 0`` records produce sends and acks and fetch polls and
matches for the ordered-log spec (``oracle.specs.LogSpec``).

Every handler takes the whole seed batch, as ``models/etcd.py`` does:
``w`` is a ``KafkaState`` of ``[S, ...]`` tensors and ``now``/``pay``/
``rand`` are per seed; ``_handle`` evaluates the five branches and
selects per lane (the reference's ``lax.switch`` under ``vmap``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Union

import torch

from ..engine import faults as efaults
from ..engine import net as enet
from ..engine.core import Emits, EngineConfig, Workload
from ..engine.ops import get1, set1, set2
from ..engine.rng import bits, bounded, fold_in, prob_to_q32
from ..oracle.history import OP_FETCH, OP_PRODUCE, PH_INVOKE, PH_OK
from . import _common

# event kinds
K_PRODUCE = 0  # pay = (producer,) — producer timer: send next unacked seq
K_FETCH = 1  # pay = (consumer,) — consumer timer: poll from current offset
K_MSG = 2  # pay = (dst_node, mtype, src_node, a, b, c)
K_FLUSH = 3  # pay = (bgen,) — broker durability timer
K_FAULT = 4  # pay = (action, victim, t_lo, t_hi) — engine/faults.py stream

# message types (slot 5 carries the history opid on fetch traffic)
MT_PRODUCE = 0  # a = seq
MT_ACK = 1  # a = ack_upto (cumulative)
MT_FETCH = 2  # a = offset
MT_FETCH_RSP = 3  # a = start_offset, b = num_records

PAYLOAD_SLOTS = 6
BROKER = 0  # node id of the broker

# violation flavors (bitmask latched in ``viol_kind``)
V_ACK_LOSS = 1  # a crash lost messages the broker had acknowledged
V_WATERMARK = 2  # the durable watermark exceeded the log end

I32 = torch.int32


class KafkaConfig(NamedTuple):
    """Static sweep parameters (the reference's fields and defaults)."""

    num_producers: int = 2
    num_consumers: int = 2
    partitions: int = 2
    msgs_per_producer: int = 16
    log_cap: int = 64  # per-partition entry capacity (retries duplicate)
    # producer retry cadence: resend the lowest unacked seq until acked
    produce_lo_ns: int = 30_000_000
    produce_hi_ns: int = 80_000_000
    # consumer poll cadence
    fetch_lo_ns: int = 40_000_000
    fetch_hi_ns: int = 120_000_000
    fetch_max: int = 4  # records per fetch response
    # broker durability cadence (flush marks the log durable)
    flush_interval_ns: int = 200_000_000
    # legacy broker-crash shorthand; `faults` overrides all four
    crashes: int = 1
    crash_window_ns: int = 3_000_000_000
    restart_lo_ns: int = 100_000_000
    restart_hi_ns: int = 800_000_000
    # network model
    loss_q32: int = prob_to_q32(0.01)
    lat_lo_ns: int = 1_000_000
    lat_hi_ns: int = 10_000_000
    buggify_q32: int = 0
    # deliberate bug for checker validation: ack on append, not at flush
    bug_ack_on_append: bool = False
    # operation-history rows per seed; 0 = recording off
    hist_slots: int = 0
    # a FaultSpec campaign, a literal FixedFaults schedule, or a
    # FaultEnvelope; None derives a broker-crash spec from the fields above
    faults: Optional[
        Union[efaults.FaultSpec, efaults.FixedFaults, efaults.FaultEnvelope]
    ] = None

    @property
    def num_nodes(self) -> int:
        return 1 + self.num_producers + self.num_consumers


def fault_spec(cfg: KafkaConfig):
    """``cfg.faults`` verbatim, or the legacy broker-crash fields lifted
    into a FaultSpec targeting the broker node only."""
    if cfg.faults is not None:
        return cfg.faults
    return efaults.FaultSpec(
        crashes=cfg.crashes,
        crash_window_ns=cfg.crash_window_ns,
        restart_lo_ns=cfg.restart_lo_ns,
        restart_hi_ns=cfg.restart_hi_ns,
        crash_group=(BROKER, BROKER + 1),
    )


def _rt(cfg: KafkaConfig, w: "KafkaState"):
    """The static spec, or this lane's ``FaultRt`` on the envelope path."""
    return efaults.runtime_spec(fault_spec(cfg), w.frt)


class KafkaState(NamedTuple):
    fstate: efaults.FaultState  # broker is node 0
    bgen: torch.Tensor  # int32[S] flush-timer generation
    # partition logs [S, P, L] (entries < log_len valid; < flushed durable)
    log_src: torch.Tensor  # int32 producer index
    log_seq: torch.Tensor  # int32
    log_len: torch.Tensor  # int32[S, P] log end offset
    flushed: torch.Tensor  # int32[S, P] durable watermark
    # cumulative ack bookkeeping [S, NP] (-1 = none)
    ack_upto: torch.Tensor  # int32 highest seq the broker acked
    dur_upto: torch.Tensor  # int32 highest seq with a durable copy
    # producers [S, NP]
    next_seq: torch.Tensor  # int32 lowest unacked seq (== M when done)
    prod_sends: torch.Tensor  # int32 produce messages actually on the wire
    # consumers [S, NC]
    cons_off: torch.Tensor  # int32 next offset to fetch
    cons_opid: torch.Tensor  # int32 history opid allocator (fetch ops)
    links: enet.LinkState
    # sweep outputs [S]
    violation: torch.Tensor  # bool (any checker)
    viol_kind: torch.Tensor  # int32 flavor bitmask (V_ACK_LOSS | V_WATERMARK)
    vio_ack_loss: torch.Tensor  # bool
    vio_watermark: torch.Tensor  # bool
    log_overflow: torch.Tensor  # bool
    produced: torch.Tensor  # int32 produce messages sent
    appended: torch.Tensor  # int32 entries appended at broker
    acked: torch.Tensor  # int32 ack messages received by producers
    fetched: torch.Tensor  # int32 records consumed
    flushes: torch.Tensor  # int32
    crash_count: torch.Tensor  # int32 crashes that hit a live broker
    msgs_sent: torch.Tensor  # int32
    msgs_delivered: torch.Tensor  # int32
    frt: object  # () on the static fault path, FaultRt on the envelope path


def _pay(*vals) -> torch.Tensor:
    return _common.pay(*vals, slots=PAYLOAD_SLOTS)


def _emits(bcast, *extras) -> Emits:
    return _common.pack_emits(PAYLOAD_SLOTS, bcast, *extras)


def _no_bcast(cfg: KafkaConfig, like: torch.Tensor):
    return _common.no_bcast(like.shape[0], cfg.num_nodes, PAYLOAD_SLOTS, K_MSG, like.device)


def _node(v, like: torch.Tensor) -> torch.Tensor:
    """A per-seed int32 node id (a python int broadcast over the batch)."""
    return torch.full_like(like, v, dtype=I32)


def _n(mask: torch.Tensor) -> torch.Tensor:
    """A per-seed bool as an int32 increment."""
    return mask.to(I32)


# -- event handlers ----------------------------------------------------------


def _on_produce_timer(cfg: KafkaConfig, w: KafkaState, now, pay, rand):
    """Producer p sends its lowest unacked seq to the broker and re-arms
    (retry-until-ack); a crashed or paused producer's timer keeps ticking
    but sends nothing."""
    p = pay[:, 0]
    seq = get1(w.next_seq, p)
    node = p + 1
    has_work = seq < cfg.msgs_per_producer
    active = has_work & get1(efaults.up(w.fstate), node)
    t, deliver = enet.route(w.links, now, node, _node(BROKER, p), rand[:, 0], rand[:, 1])
    send = active & deliver
    interval = efaults.skewed_delay(
        fault_spec(cfg), w.fstate, node,
        bounded(rand[:, 2], cfg.produce_lo_ns, cfg.produce_hi_ns), rt=_rt(cfg, w),
    )
    emits = _emits(
        _no_bcast(cfg, p),
        (t, K_MSG, _pay(BROKER, MT_PRODUCE, node, seq), send),
        (now + interval, K_PRODUCE, _pay(p), has_work),
    )
    w2 = w._replace(
        produced=w.produced + _n(active),
        # on the wire: the record hook's invoke marker (a send the network
        # dropped never reached the broker)
        prod_sends=set1(w.prod_sends, p, get1(w.prod_sends, p) + 1, send),
        msgs_sent=w.msgs_sent + _n(active),
        msgs_delivered=w.msgs_delivered + _n(send),
    )
    return w2, emits


def _on_fetch_timer(cfg: KafkaConfig, w: KafkaState, now, pay, rand):
    """Consumer c polls the broker from its current offset and re-arms; a
    crashed or paused consumer's timer keeps ticking but sends nothing."""
    c = pay[:, 0]
    node = c + 1 + cfg.num_producers
    can_send = get1(efaults.up(w.fstate), node)
    t, deliver = enet.route(w.links, now, node, _node(BROKER, c), rand[:, 0], rand[:, 1])
    sent = can_send & deliver
    opid = get1(w.cons_opid, c)
    interval = efaults.skewed_delay(
        fault_spec(cfg), w.fstate, node,
        bounded(rand[:, 2], cfg.fetch_lo_ns, cfg.fetch_hi_ns), rt=_rt(cfg, w),
    )
    emits = _emits(
        _no_bcast(cfg, c),
        (t, K_MSG, _pay(BROKER, MT_FETCH, node, get1(w.cons_off, c), 0, opid), sent),
        (now + interval, K_FETCH, _pay(c), True),
    )
    w2 = w._replace(
        cons_opid=set1(w.cons_opid, c, opid + 1, sent),
        msgs_sent=w.msgs_sent + _n(can_send),
        msgs_delivered=w.msgs_delivered + _n(sent),
    )
    return w2, emits


def _compute_dur_upto(cfg: KafkaConfig, log_src, log_seq, flushed):
    """``dur_upto[s, p]`` = highest seq among producer p's durable
    entries (-1 if none): a dense ``[S, NP, P, L]`` masked max, exact
    because per-producer append order has no gaps."""
    dev = log_src.device
    pos = torch.arange(cfg.log_cap, dtype=I32, device=dev)
    durable = pos[None, None, :] < flushed[:, :, None]  # [S, P, L]
    producers = torch.arange(cfg.num_producers, dtype=I32, device=dev)[None, :, None, None]
    mine = (log_src[:, None] == producers) & durable[:, None]  # [S, NP, P, L]
    return torch.where(mine, log_seq[:, None], -1).amax(dim=(2, 3)).to(I32)


def _on_msg(cfg: KafkaConfig, w: KafkaState, now, pay, rand):
    dst, mtype, src, a, b = (pay[:, i] for i in range(5))
    np_ = cfg.num_producers
    up = efaults.up(w.fstate)
    at_broker = dst == BROKER
    alive = up[:, BROKER]

    # -- broker: PRODUCE — append at the log end of the producer's
    # partition (keyed assignment producer -> partition)
    is_produce = at_broker & alive & (mtype == MT_PRODUCE)
    producer = src - 1
    part_p = producer % cfg.partitions
    len_p = get1(w.log_len, part_p)
    room = len_p < cfg.log_cap
    do_append = is_produce & room
    seq = a
    log_src2 = set2(w.log_src, part_p, len_p, producer, do_append)
    log_seq2 = set2(w.log_seq, part_p, len_p, seq, do_append)
    log_len2 = set1(w.log_len, part_p, len_p + 1, do_append)

    # ack policy: the bug acks on append; correct mode acks at flush.
    # Either way a duplicate produce of an already-acked seq re-sends the
    # cumulative ack (the original may have been lost)
    if cfg.bug_ack_on_append:
        new_ack_p = torch.maximum(get1(w.ack_upto, producer), seq)
        ack_upto2 = set1(w.ack_upto, producer, new_ack_p, do_append)
        send_ack = do_append
    else:
        ack_upto2 = w.ack_upto
        new_ack_p = get1(w.ack_upto, producer)
        send_ack = is_produce & (seq <= new_ack_p)

    # -- broker: FETCH — serve up to fetch_max records from the offset,
    # bounded by the durable watermark
    is_fetch = at_broker & alive & (mtype == MT_FETCH)
    consumer = src - 1 - np_
    part_c = consumer % cfg.partitions
    off = a
    nrec = torch.clamp(get1(w.flushed, part_c) - off, 0, cfg.fetch_max)

    # -- producer: ACK (cumulative) — advance next_seq past the frontier;
    # a crashed or paused client drops in-flight receives
    is_ack = (mtype == MT_ACK) & (dst >= 1) & (dst <= np_) & get1(up, dst)
    ack_dst = dst - 1
    adv = torch.maximum(get1(w.next_seq, ack_dst), a + 1)
    next_seq2 = set1(w.next_seq, ack_dst, adv, is_ack)

    # -- consumer: FETCH_RSP — advance only on a response matching the
    # current offset (stale responses are dropped)
    is_rsp = (mtype == MT_FETCH_RSP) & (dst > np_) & get1(up, dst)
    rsp_c = dst - 1 - np_
    match = is_rsp & (a == get1(w.cons_off, rsp_c))
    cons_off2 = set1(w.cons_off, rsp_c, a + b, match)

    # reply slot: ACK (produce) or FETCH_RSP (fetch, echoing the opid)
    rt, rdeliver = enet.route(w.links, now, _node(BROKER, dst), src, rand[:, 0], rand[:, 1])
    reply_pay = torch.where(
        is_fetch[:, None],
        _pay(src, MT_FETCH_RSP, BROKER, off, nrec, pay[:, 5]),
        _pay(src, MT_ACK, BROKER, new_ack_p),
    )
    reply_sent = is_fetch | send_ack
    reply_on = reply_sent & rdeliver
    emits = _emits(_no_bcast(cfg, dst), (rt, K_MSG, reply_pay, reply_on), None)
    w2 = w._replace(
        log_src=log_src2,
        log_seq=log_seq2,
        log_len=log_len2,
        ack_upto=ack_upto2,
        next_seq=next_seq2,
        cons_off=cons_off2,
        log_overflow=w.log_overflow | (is_produce & ~room),
        appended=w.appended + _n(do_append),
        acked=w.acked + _n(is_ack),
        fetched=w.fetched + torch.where(match, b, 0),
        msgs_sent=w.msgs_sent + _n(reply_sent),
        msgs_delivered=w.msgs_delivered + _n(reply_on),
    )
    return w2, emits


def _on_flush(cfg: KafkaConfig, w: KafkaState, now, pay, rand):
    """Advance the durable watermark to the log end; in correct mode this
    is also the ack point: one cumulative ack per producer whose durable
    frontier moved. Inside a slow-disk window (``fsync_stall``) the timer
    ticks on but the watermark freezes."""
    gen = pay[:, 0]
    f = w.fstate
    valid = efaults.up(f)[:, BROKER] & (gen == w.bgen)
    do_flush = valid & ~efaults.stalled(f)[:, BROKER]
    flushed2 = torch.where(do_flush[:, None], w.log_len, w.flushed)
    dur2 = torch.where(
        do_flush[:, None], _compute_dur_upto(cfg, w.log_src, w.log_seq, flushed2), w.dur_upto
    )
    # watermark sanity, checked before the update (after it the two are
    # equal by construction)
    bad_wm = do_flush & (w.flushed > w.log_len).any(dim=1)

    if cfg.bug_ack_on_append:
        ack2 = w.ack_upto  # acks already went out at append time
        advanced = torch.zeros_like(w.ack_upto, dtype=torch.bool)
    else:
        advanced = do_flush[:, None] & (dur2 > w.ack_upto)
        ack2 = torch.where(advanced, dur2, w.ack_upto)

    # broadcast slots: one cumulative ack per producer with a moved
    # frontier (slots of non-producer nodes stay disabled)
    n, np_ = cfg.num_nodes, cfg.num_producers
    u = rand[:, : 2 * n].reshape(-1, n, 2)
    times, deliver = enet.route_from(w.links, now, _node(BROKER, gen), u[:, :, 0], u[:, :, 1])
    node_ids = torch.arange(n, dtype=I32, device=gen.device)
    is_producer_slot = (node_ids >= 1) & (node_ids <= np_)
    slot_producer = torch.clamp(node_ids - 1, 0, np_ - 1).to(torch.int64)
    slot_adv = advanced[:, slot_producer] & is_producer_slot
    slot_ack = ack2[:, slot_producer]
    pays = torch.zeros((gen.shape[0], n, PAYLOAD_SLOTS), dtype=I32, device=gen.device)
    pays[:, :, 0] = node_ids
    pays[:, :, 1] = MT_ACK
    pays[:, :, 2] = BROKER
    pays[:, :, 3] = slot_ack
    enables = slot_adv & deliver
    bcast = (times, torch.full_like(pays[:, :, 0], K_MSG), pays, enables)

    flush_dt = efaults.skewed_delay(
        fault_spec(cfg), f, _node(BROKER, gen), cfg.flush_interval_ns, rt=_rt(cfg, w)
    )
    emits = _emits(bcast, (now + flush_dt, K_FLUSH, _pay(gen), valid), None)
    w2 = w._replace(
        flushed=flushed2,
        dur_upto=dur2,
        ack_upto=ack2,
        flushes=w.flushes + _n(do_flush),
        vio_watermark=w.vio_watermark | bad_wm,
        violation=w.violation | bad_wm,
        viol_kind=w.viol_kind | _n(bad_wm) * V_WATERMARK,
        msgs_sent=w.msgs_sent + slot_adv.sum(dim=1, dtype=I32),
        msgs_delivered=w.msgs_delivered + enables.sum(dim=1, dtype=I32),
    )
    return w2, emits


def _on_fault(cfg: KafkaConfig, w: KafkaState, now, pay, rand):
    """One event of the compiled fault campaign: the shared interpreter
    updates the liveness and pause masks and the links; for the broker a
    crash loses everything past the durable watermark (the ack-loss
    checker's moment), a crash or pause kills the flush-timer chain
    (``bgen`` bump) and a restart or resume re-arms it."""
    action, victim = pay[:, 0], pay[:, 1]
    base = efaults.NetBase(cfg.lat_lo_ns, cfg.lat_hi_ns, cfg.loss_q32)
    links2, f2, e = efaults.on_event(_rt(cfg, w), base, w.links, w.fstate, action, victim)
    at_broker = victim == BROKER
    crashed = e.crashed & at_broker
    stopped = (e.crashed | e.paused) & at_broker
    revived = (e.restarted | e.resumed) & at_broker

    lost_acked = (w.ack_upto > w.dur_upto).any(dim=1)
    bad_wm = (w.flushed > w.log_len).any(dim=1)
    bgen2 = w.bgen + _n(stopped)
    w2 = w._replace(
        links=links2,
        fstate=f2,
        bgen=bgen2,
        log_len=torch.where(crashed[:, None], w.flushed, w.log_len),
        vio_ack_loss=w.vio_ack_loss | (crashed & lost_acked),
        vio_watermark=w.vio_watermark | (crashed & bad_wm),
        violation=w.violation | (crashed & (lost_acked | bad_wm)),
        viol_kind=w.viol_kind
        | _n(crashed & lost_acked) * V_ACK_LOSS
        | _n(crashed & bad_wm) * V_WATERMARK,
        crash_count=w.crash_count + _n(crashed),
    )
    flush_dt = efaults.skewed_delay(
        fault_spec(cfg), f2, _node(BROKER, action), cfg.flush_interval_ns, rt=_rt(cfg, w)
    )
    emits = _emits(
        _no_bcast(cfg, action), (now + flush_dt, K_FLUSH, _pay(bgen2), revived), None
    )
    return w2, emits


_BRANCHES = (_on_produce_timer, _on_fetch_timer, _on_msg, _on_flush, _on_fault)


def _handle(cfg: KafkaConfig, w: KafkaState, now, kind, pay, rand):
    return _common.switch(kind, [partial(br, cfg) for br in _BRANCHES], w, now, pay, rand)


def _probe(w: KafkaState):
    """Violation-flavor bitmask (recorded per step by ``run_traced``)."""
    return w.viol_kind


def _record(cfg: KafkaConfig, wb: KafkaState, wa: KafkaState, now, kind, pay):
    """Each dispatched event's op-history row (at most one). Producers
    are history clients 0..NP-1 and consumers NP..NP+NC-1. A produce
    send's opid is its seq (retries re-invoke it); an ack that advances
    the producer's frontier completes the frontier seq; a fetch uses the
    consumer's opid echoed through pay slot 5 and completes only on the
    offset-matching response."""
    np_, nc = cfg.num_producers, cfg.num_consumers

    # produce invoke: the timer put seq on the wire (prod_sends bumped)
    p = torch.clamp(pay[:, 0], 0, np_ - 1)
    p_sent = (kind == K_PRODUCE) & (get1(wa.prod_sends, p) > get1(wb.prod_sends, p))
    p_seq = get1(wb.next_seq, p)

    # fetch invoke: the poll timer sent (cons_opid bumped)
    c = torch.clamp(pay[:, 0], 0, nc - 1)
    f_sent = (kind == K_FETCH) & (get1(wa.cons_opid, c) > get1(wb.cons_opid, c))
    f_opid = get1(wb.cons_opid, c)
    f_off = get1(wb.cons_off, c)

    # completions ride on delivered K_MSG events at the clients
    dst, mtype, a, b = pay[:, 0], pay[:, 1], pay[:, 3], pay[:, 4]
    ack_p = torch.clamp(dst - 1, 0, np_ - 1)
    acked = (kind == K_MSG) & (mtype == MT_ACK) & (
        get1(wa.next_seq, ack_p) > get1(wb.next_seq, ack_p)
    )
    rsp_c = torch.clamp(dst - 1 - np_, 0, nc - 1)
    matched = (kind == K_MSG) & (mtype == MT_FETCH_RSP) & (
        get1(wa.cons_off, rsp_c) > get1(wb.cons_off, rsp_c)
    )

    def pick(pv, fv, av, mv):
        return torch.where(
            p_sent, pv, torch.where(f_sent, fv, torch.where(acked, av, mv))
        ).to(I32)

    parts = cfg.partitions
    rec = torch.stack(
        [
            pick(p, np_ + c, ack_p, np_ + rsp_c),
            pick(
                OP_PRODUCE * 2 + PH_INVOKE,
                OP_FETCH * 2 + PH_INVOKE,
                OP_PRODUCE * 2 + PH_OK,
                torch.full_like(p, OP_FETCH * 2 + PH_OK),
            ),
            pick(p % parts, c % parts, ack_p % parts, rsp_c % parts),
            pick(p_seq, f_off, a, b),
            pick(p_seq, f_opid, a, pay[:, 5]),
        ],
        dim=1,
    )
    return rec, p_sent | f_sent | acked | matched


def _init(cfg: KafkaConfig, key: torch.Tensor, params=None):
    """Batched initial state and event set from key words ``[S, 2]``;
    ``params`` are the lanes' ``FaultParams`` when ``cfg.faults`` is a
    ``FaultEnvelope``."""
    np_, nc = cfg.num_producers, cfg.num_consumers
    s, dev = key.shape[0], key.device
    # init draws live in their own counter namespace (0x7FFF_FFFF), as
    # 32-bit words held in int64
    rand = bits(fold_in(key, 0x7FFF_FFFF), np_ + nc + 1)
    nn, parts, cap = cfg.num_nodes, cfg.partitions, cfg.log_cap

    def z(shape, dtype, fill=0):
        return torch.full((s,) + shape, fill, dtype=dtype, device=dev)

    w = KafkaState(
        fstate=efaults.init_state(s, nn, device=dev),
        bgen=z((), I32),
        log_src=z((parts, cap), I32, -1),
        log_seq=z((parts, cap), I32, -1),
        log_len=z((parts,), I32),
        flushed=z((parts,), I32),
        ack_upto=z((np_,), I32, -1),
        dur_upto=z((np_,), I32, -1),
        next_seq=z((np_,), I32),
        prod_sends=z((np_,), I32),
        cons_off=z((nc,), I32),
        cons_opid=z((nc,), I32),
        links=enet.make(
            s, nn, cfg.loss_q32, cfg.lat_lo_ns, cfg.lat_hi_ns, cfg.buggify_q32, device=dev
        ),
        violation=z((), torch.bool),
        viol_kind=z((), I32),
        vio_ack_loss=z((), torch.bool),
        vio_watermark=z((), torch.bool),
        log_overflow=z((), torch.bool),
        produced=z((), I32),
        appended=z((), I32),
        acked=z((), I32),
        fetched=z((), I32),
        flushes=z((), I32),
        crash_count=z((), I32),
        msgs_sent=z((), I32),
        msgs_delivered=z((), I32),
        frt=efaults.make_rt(fault_spec(cfg), params),
    )
    # producer timers, consumer timers, then the first flush tick
    times, kinds, pays = [], [], []
    for p in range(np_):
        times.append(bounded(rand[:, p], 0, cfg.produce_hi_ns))
        kinds.append(K_PRODUCE)
        pays.append(_pay(z((), I32, p)))
    for c in range(nc):
        times.append(bounded(rand[:, np_ + c], 0, cfg.fetch_hi_ns))
        kinds.append(K_FETCH)
        pays.append(_pay(z((), I32, c)))
    times.append(z((), torch.int64, cfg.flush_interval_ns))
    kinds.append(K_FLUSH)
    pays.append(_pay(z((), I32, 0)))
    fe = efaults.compile_device(fault_spec(cfg), nn, key, K_FAULT, PAYLOAD_SLOTS, params=params)
    ninit = len(kinds)
    return w, Emits(
        times=torch.cat([torch.stack(times, dim=1), fe.times], dim=1),
        kinds=torch.cat(
            [torch.tensor(kinds, dtype=I32, device=dev).expand(s, -1), fe.kinds], dim=1
        ),
        pays=torch.cat([torch.stack(pays, dim=1), fe.pays], dim=1),
        enables=torch.cat(
            [torch.ones((s, ninit), dtype=torch.bool, device=dev), fe.enables], dim=1
        ),
    )


def history_spec():
    """The sequential spec this model's histories check against
    (``oracle.specs.LogSpec``), also the key of its device screen."""
    from ..oracle.specs import LogSpec

    return LogSpec()


@_common.memoized_workload(KafkaConfig)
def workload(cfg: KafkaConfig = None) -> Workload:
    """The engine Workload for a Kafka sweep configuration (memoized)."""
    return Workload(
        init=partial(_init, cfg),
        handle=partial(_handle, cfg),
        num_rand=2 * cfg.num_nodes + 3,
        payload_slots=PAYLOAD_SLOTS,
        max_emits=cfg.num_nodes + 2,
        probe=_probe,
        record=partial(_record, cfg) if cfg.hist_slots > 0 else None,
        hist_slots=cfg.hist_slots,
    )


def engine_config(cfg: KafkaConfig = KafkaConfig(), **overrides) -> EngineConfig:
    """Engine parameters (the reference's queue sizing: one timer chain
    per actor, at most one request and reply per client, the flush acks
    and the fault plan)."""
    defaults = dict(
        queue_capacity=max(
            48,
            4 * (cfg.num_producers + cfg.num_consumers)
            + cfg.num_nodes
            + efaults.num_events(fault_spec(cfg))
            + 4,
        ),
        time_limit_ns=5_000_000_000,
        max_steps=200_000,
    )
    defaults.update(overrides)
    return EngineConfig(**defaults)


sweep_summary = _common.make_sweep_summary(
    (
        ("violations", lambda f: f.wstate.violation),
        ("ack_loss_seeds", lambda f: f.wstate.vio_ack_loss),
        ("watermark_seeds", lambda f: f.wstate.vio_watermark),
        ("produced", lambda f: f.wstate.produced),
        ("appended", lambda f: f.wstate.appended),
        ("acked", lambda f: f.wstate.acked),
        ("fetched", lambda f: f.wstate.fetched),
        ("flushes", lambda f: f.wstate.flushes),
        ("crashes", lambda f: f.wstate.crash_count),
        ("log_overflow_seeds", lambda f: f.wstate.log_overflow),
        ("msgs_sent", lambda f: f.wstate.msgs_sent),
        ("msgs_delivered", lambda f: f.wstate.msgs_delivered),
    )
)
