"""S3 object store as a batched workload (counterpart of
``madsim_tpu/models/s3.py``).

One S3 server (node 0) and ``num_clients`` clients per seed, each
driving a random op mix — put, get and delete of an object and the
multipart lifecycle (create, upload parts, complete) — re-sending its
in-flight request until it is acknowledged, under server crash/restart
faults and per-message loss and latency. A crash rolls the committed
tier back to the durable tier and aborts every staged upload (its client
sees NoSuchUpload, keyed by the upload's ``gen``, and restarts it). Two
online checkers latch ``violation``: every acknowledged object version
has a durable copy at a crash (``bug_ack_before_durable`` acks at
processing time but defers durability to a periodic flush, and breaks
it), and the version a GET serves never regresses.

Every handler takes the whole seed batch, as ``models/etcd.py`` does;
``_handle`` evaluates the four branches and selects per lane (the
reference's ``lax.switch`` under ``vmap``). ``_on_msg`` is the largest
branch: every lane computes the server's and the client's side of every
message type.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Union

import torch

from ..engine import faults as efaults
from ..engine import net as enet
from ..engine.core import Emits, EngineConfig, Workload
from ..engine.ops import get1, set1
from ..engine.rng import bits, bounded, fold_in, prob_to_q32
from . import _common

# event kinds
K_OP = 0  # pay = (client,) — client timer: start or re-send current op
K_MSG = 1  # pay = (dst_node, mtype, src_node, a, b, key echo)
K_FLUSH = 2  # pay = (sgen,) — server durability timer (bug mode)
K_FAULT = 3  # pay = (action, victim, t_lo, t_hi) — engine/faults.py stream

# message types (pay slots a/b per type)
MT_PUT = 1  # a = key, b = len
MT_GET = 2  # a = key
MT_DEL = 3  # a = key
MT_CREATE = 4  # a = key
MT_PART = 5  # a = gen, b = part index
MT_COMPLETE = 6  # a = gen
MT_PUT_ACK = 7  # a = version
MT_GET_RSP = 8  # a = version, b = len (-1 = absent)
MT_DEL_ACK = 9  # a = version
MT_CREATE_ACK = 10  # a = gen
MT_PART_ACK = 11  # a = gen, b = part index
MT_COMP_ACK = 12  # a = gen
MT_ERR = 13  # a = gen — NoSuchUpload

# client phases
IDLE = 0
P_PUT = 1
P_GET = 2
P_DEL = 3
P_MPC = 4  # create_multipart_upload sent
P_MPP = 5  # uploading parts
P_MPX = 6  # complete_multipart_upload sent

PAYLOAD_SLOTS = 6
SERVER = 0

# op mix: the 8 values of a draw -> the phase started (3/8 put, 2/8 get,
# 1/8 delete, 2/8 multipart)
_OP_PHASE = (P_PUT, P_PUT, P_PUT, P_GET, P_GET, P_DEL, P_MPC, P_MPC)
# phase -> request mtype: the identity on 0..6, so a phase is its mtype
_REQ_MTYPE = (0, MT_PUT, MT_GET, MT_DEL, MT_CREATE, MT_PART, MT_COMPLETE)
assert _REQ_MTYPE == tuple(range(P_MPX + 1))

I32 = torch.int32


class S3Config(NamedTuple):
    """Static sweep parameters (the reference's fields and defaults)."""

    num_clients: int = 3
    num_keys: int = 4
    ops_per_client: int = 10
    parts_per_upload: int = 3
    part_len: int = 4  # every part is one fixed-size unit
    max_put_len: int = 4  # put_object length drawn from 1..max_put_len
    # client op/retry cadence
    op_lo_ns: int = 30_000_000
    op_hi_ns: int = 80_000_000
    # server durability cadence (bug mode only: correct mode commits
    # durably at processing time)
    flush_interval_ns: int = 200_000_000
    # legacy server-crash shorthand; `faults` overrides all four
    crashes: int = 1
    crash_window_ns: int = 3_000_000_000
    restart_lo_ns: int = 100_000_000
    restart_hi_ns: int = 800_000_000
    # network model
    loss_q32: int = prob_to_q32(0.01)
    lat_lo_ns: int = 1_000_000
    lat_hi_ns: int = 10_000_000
    buggify_q32: int = 0
    # deliberate bug for checker validation: ack at processing time but
    # make durable only at the periodic flush
    bug_ack_before_durable: bool = False
    # a FaultSpec campaign, a literal FixedFaults schedule, or a
    # FaultEnvelope; None derives a server-crash spec from the fields above
    faults: Optional[
        Union[efaults.FaultSpec, efaults.FixedFaults, efaults.FaultEnvelope]
    ] = None

    @property
    def num_nodes(self) -> int:
        return 1 + self.num_clients


def fault_spec(cfg: S3Config):
    """``cfg.faults`` verbatim, or the legacy server-crash fields lifted
    into a FaultSpec targeting the server node only."""
    if cfg.faults is not None:
        return cfg.faults
    return efaults.FaultSpec(
        crashes=cfg.crashes,
        crash_window_ns=cfg.crash_window_ns,
        restart_lo_ns=cfg.restart_lo_ns,
        restart_hi_ns=cfg.restart_hi_ns,
        crash_group=(SERVER, SERVER + 1),
    )


def _rt(cfg: S3Config, w: "S3State"):
    """The static spec, or this lane's ``FaultRt`` on the envelope path."""
    return efaults.runtime_spec(fault_spec(cfg), w.frt)


class S3State(NamedTuple):
    fstate: efaults.FaultState  # server is node 0
    sgen: torch.Tensor  # int32[S] flush-timer generation
    # committed object table [S, K] (version 0 = never written, len -1 = absent)
    ver_com: torch.Tensor  # int32
    len_com: torch.Tensor  # int32
    # durable tier [S, K] (== committed in correct mode)
    ver_dur: torch.Tensor  # int32
    len_dur: torch.Tensor  # int32
    # checker bookkeeping [S, K]
    last_acked_ver: torch.Tensor  # int32 highest version a success ack promised
    max_served_ver: torch.Tensor  # int32 highest version any GET served
    # multipart staging, one active upload per client [S, NC]
    gen_ctr: torch.Tensor  # int32[S] upload-id source
    mp_gen: torch.Tensor  # int32 registered upload gen (0 = none)
    mp_key: torch.Tensor  # int32
    mp_mask: torch.Tensor  # int32 bitmask of staged parts
    mp_done_gen: torch.Tensor  # int32 last completed gen (idempotent re-ack)
    # clients [S, NC]
    phase: torch.Tensor  # int32
    cur_key: torch.Tensor  # int32
    cur_len: torch.Tensor  # int32
    cur_gen: torch.Tensor  # int32
    cur_part: torch.Tensor  # int32 next part index to upload
    ops_done: torch.Tensor  # int32
    links: enet.LinkState
    # sweep outputs [S]
    violation: torch.Tensor  # bool (any checker)
    vio_ack_loss: torch.Tensor  # bool
    vio_regress: torch.Tensor  # bool
    puts: torch.Tensor  # int32 put_object commits
    gets: torch.Tensor  # int32 get_object serves
    dels: torch.Tensor  # int32 delete_object commits
    creates: torch.Tensor  # int32 multipart registrations
    parts_recv: torch.Tensor  # int32 distinct parts staged
    completes: torch.Tensor  # int32 multipart assemblies
    upload_restarts: torch.Tensor  # int32 NoSuchUpload-driven restarts
    crash_count: torch.Tensor  # int32 crashes that hit a live server
    msgs_sent: torch.Tensor  # int32
    msgs_delivered: torch.Tensor  # int32
    frt: object  # () on the static fault path, FaultRt on the envelope path


def _pay(*vals) -> torch.Tensor:
    return _common.pay(*vals, slots=PAYLOAD_SLOTS)


def _emits(like: torch.Tensor, *extras) -> Emits:
    """Every handler emits exactly 2 fixed slots (no broadcasts here)."""
    return _common.pack_extras(PAYLOAD_SLOTS, like.shape[0], like.device, *extras)


def _node(v, like: torch.Tensor) -> torch.Tensor:
    """A per-seed int32 node id (a python int broadcast over the batch)."""
    return torch.full_like(like, v, dtype=I32)


def _n(mask: torch.Tensor) -> torch.Tensor:
    """A per-seed bool as an int32 increment."""
    return mask.to(I32)


def _select(conds, vals, default):
    """``jnp.select``: per lane, the value of the first true condition."""
    out = default
    for c, v in reversed(list(zip(conds, vals))):
        out = torch.where(c, v, out)
    return out.to(I32) if isinstance(out, torch.Tensor) else out


def _bit(b: torch.Tensor) -> torch.Tensor:
    """``1 << b`` in int32 as XLA shifts it: 0 for a shift outside [0, 32)."""
    ok = (b >= 0) & (b < 32)
    word = torch.ones_like(b, dtype=torch.int64) << torch.clamp(b, 0, 31).to(torch.int64)
    return torch.where(ok, word, 0).to(I32)


# -- event handlers ----------------------------------------------------------


def _on_op_timer(cfg: S3Config, w: S3State, now, pay, rand):
    """Client c starts a new op (when idle, budget permitting) or re-sends
    the in-flight request, then re-arms (retry-until-ack)."""
    c = pay[:, 0]
    node = c + 1
    phase = get1(w.phase, c)
    budget_left = get1(w.ops_done, c) < cfg.ops_per_client
    node_up = get1(efaults.up(w.fstate), node)
    start = (phase == IDLE) & budget_left & node_up

    op = bounded(rand[:, 3], 0, 8)
    op_phase = torch.where(
        op < 3, P_PUT, torch.where(op < 5, P_GET, torch.where(op < 6, P_DEL, P_MPC))
    ).to(I32)
    key = bounded(rand[:, 4], 0, cfg.num_keys).to(I32)
    plen = bounded(rand[:, 5], 1, cfg.max_put_len + 1).to(I32)

    phase2 = torch.where(start, op_phase, phase)
    key2 = torch.where(start, key, get1(w.cur_key, c))
    len2 = torch.where(start, plen, get1(w.cur_len, c))
    gen = get1(w.cur_gen, c)
    part = get1(w.cur_part, c)

    mtype = phase2  # _REQ_MTYPE is the identity
    a = torch.where(phase2 >= P_MPP, gen, key2)
    b = torch.where(phase2 == P_PUT, len2, torch.where(phase2 == P_MPP, part, 0))

    active = (phase2 != IDLE) & node_up
    t, deliver = enet.route(w.links, now, node, _node(SERVER, c), rand[:, 0], rand[:, 1])
    send = active & deliver
    interval = efaults.skewed_delay(
        fault_spec(cfg), w.fstate, node,
        bounded(rand[:, 2], cfg.op_lo_ns, cfg.op_hi_ns), rt=_rt(cfg, w),
    )
    emits = _emits(
        c,
        (t, K_MSG, _pay(SERVER, mtype, node, a, b), send),
        (now + interval, K_OP, _pay(c), (phase2 != IDLE) | budget_left),
    )
    w2 = w._replace(
        phase=set1(w.phase, c, phase2, start),
        cur_key=set1(w.cur_key, c, key2, start),
        cur_len=set1(w.cur_len, c, len2, start),
        msgs_sent=w.msgs_sent + _n(active),
        msgs_delivered=w.msgs_delivered + _n(send),
    )
    return w2, emits


def _on_msg(cfg: S3Config, w: S3State, now, pay, rand):
    dst, mtype, src, a, b = (pay[:, i] for i in range(5))
    nc = cfg.num_clients
    up = efaults.up(w.fstate)
    srv = (dst == SERVER) & up[:, SERVER]
    cc = torch.clamp(src - 1, 0, nc - 1)  # requesting client
    sync = not cfg.bug_ack_before_durable  # commit == durable

    # -- server: PUT / DELETE — a version bump on the committed tier (a
    # delete writes "absent", so per-key versions stay monotone)
    is_put = srv & (mtype == MT_PUT)
    is_del = srv & (mtype == MT_DEL)
    is_write = is_put | is_del
    wkey = a
    wlen = torch.where(is_put, b, -1)
    wver = get1(w.ver_com, wkey) + 1

    # -- server: COMPLETE — assemble the staged parts iff the registration
    # is current and every part arrived; a stale gen re-acks if it was
    # the last completed one, else NoSuchUpload
    is_comp = srv & (mtype == MT_COMPLETE)
    comp_cur = (get1(w.mp_gen, cc) == a) & (a != 0)
    full = get1(w.mp_mask, cc) == (1 << cfg.parts_per_upload) - 1
    do_assemble = is_comp & comp_cur & full
    akey = get1(w.mp_key, cc)
    aver = get1(w.ver_com, akey) + 1
    alen = cfg.parts_per_upload * cfg.part_len
    comp_reack = is_comp & ~comp_cur & (get1(w.mp_done_gen, cc) == a)

    # the write, then the assembly (different mtypes, never both)
    ver_com2 = set1(set1(w.ver_com, wkey, wver, is_write), akey, aver, do_assemble)
    len_com2 = set1(set1(w.len_com, wkey, wlen, is_write), akey, alen, do_assemble)
    if sync:
        ver_dur2 = set1(set1(w.ver_dur, wkey, wver, is_write), akey, aver, do_assemble)
        len_dur2 = set1(set1(w.len_dur, wkey, wlen, is_write), akey, alen, do_assemble)
    else:
        ver_dur2, len_dur2 = w.ver_dur, w.len_dur
    # the durability promise is made when the success response is made
    last_acked2 = set1(set1(w.last_acked_ver, wkey, wver, is_write), akey, aver, do_assemble)
    mp_gen2 = set1(w.mp_gen, cc, 0, do_assemble)
    mp_done_gen2 = set1(w.mp_done_gen, cc, a, do_assemble)

    # -- server: GET — serve the committed version; the monotonic-serve
    # checker latches if a previously served version regressed
    is_get = srv & (mtype == MT_GET)
    gver = get1(ver_com2, a)
    glen = get1(len_com2, a)
    served = get1(w.max_served_ver, a)
    regress = is_get & (gver < served)
    max_served2 = set1(w.max_served_ver, a, torch.maximum(gver, served), is_get)

    # -- server: CREATE — register (or re-ack) this client's upload; a
    # fresh server-issued gen is the upload id
    is_create = srv & (mtype == MT_CREATE)
    reg_gen = get1(w.mp_gen, cc)
    has_reg = reg_gen != 0
    new_gen = w.gen_ctr + 1
    do_register = is_create & ~has_reg
    gen_ctr2 = torch.where(do_register, new_gen, w.gen_ctr)
    ack_gen = torch.where(has_reg, reg_gen, new_gen)
    mp_gen2 = set1(mp_gen2, cc, new_gen, do_register)
    mp_key2 = set1(w.mp_key, cc, a, do_register)
    mp_mask2 = set1(w.mp_mask, cc, 0, do_register)

    # -- server: PART — stage into the bitmask iff the gen is current
    # (retried duplicates are idempotent); a stale gen is NoSuchUpload
    is_part = srv & (mtype == MT_PART)
    part_cur = (reg_gen == a) & (a != 0)
    old_mask = get1(mp_mask2, cc)
    bit = _bit(b)
    fresh_part = is_part & part_cur & ((old_mask & bit) == 0)
    mp_mask2 = set1(mp_mask2, cc, old_mask | bit, is_part & part_cur)

    # -- the server's reply (one per request processed while alive)
    finished_comp = do_assemble | comp_reack
    rmt = _select(
        [is_put, is_del, is_get, is_create, is_part & part_cur, is_part & ~part_cur,
         finished_comp, is_comp & ~finished_comp],
        [MT_PUT_ACK, MT_DEL_ACK, MT_GET_RSP, MT_CREATE_ACK, MT_PART_ACK, MT_ERR,
         MT_COMP_ACK, MT_ERR],
        torch.zeros_like(a),
    )
    ra = _select([is_write, is_get, is_create, is_part | is_comp], [wver, gver, ack_gen, a],
                 torch.zeros_like(a))
    rb = _select([is_get, is_part], [glen, b], torch.zeros_like(a))
    # slot 5 echoes the key on put/get/del acks, so a delayed ack of an
    # earlier op cannot complete a later op on another key
    rkey = _select([is_write, is_get], [wkey, a], torch.zeros_like(a))
    did_req = is_write | is_get | is_create | is_part | is_comp
    rt, rdeliver = enet.route(w.links, now, _node(SERVER, dst), src, rand[:, 0], rand[:, 1])
    reply_on = did_req & rdeliver

    # -- client: response handling (stale responses gated by phase/gen)
    at_client = (dst >= 1) & (mtype >= MT_PUT_ACK) & get1(up, dst)
    rc = torch.clamp(dst - 1, 0, nc - 1)
    cphase = get1(w.phase, rc)
    cgen = get1(w.cur_gen, rc)
    cpart = get1(w.cur_part, rc)
    key_ok = pay[:, 5] == get1(w.cur_key, rc)

    fin_put = at_client & (mtype == MT_PUT_ACK) & (cphase == P_PUT) & key_ok
    fin_get = at_client & (mtype == MT_GET_RSP) & (cphase == P_GET) & key_ok
    fin_del = at_client & (mtype == MT_DEL_ACK) & (cphase == P_DEL) & key_ok
    got_create = at_client & (mtype == MT_CREATE_ACK) & (cphase == P_MPC)
    got_part = (
        at_client & (mtype == MT_PART_ACK) & (cphase == P_MPP) & (a == cgen) & (b == cpart)
    )
    last_part = got_part & (cpart + 1 == cfg.parts_per_upload)
    fin_comp = at_client & (mtype == MT_COMP_ACK) & (cphase == P_MPX) & (a == cgen)
    got_err = (
        at_client & (mtype == MT_ERR) & ((cphase == P_MPP) | (cphase == P_MPX)) & (a == cgen)
    )
    fin_op = fin_put | fin_get | fin_del | fin_comp

    nphase = _select(
        [fin_op, got_create, last_part, got_part, got_err],
        # NoSuchUpload restarts the whole upload
        [IDLE, P_MPP, P_MPX, P_MPP, P_MPC],
        cphase,
    )
    touched = fin_op | got_create | got_part | got_err
    phase2 = set1(w.phase, rc, nphase, touched)
    cur_gen2 = set1(w.cur_gen, rc, a, got_create)
    cur_part2 = set1(
        w.cur_part, rc, torch.where(got_create, 0, cpart + 1), got_create | got_part
    )
    ops_done2 = set1(w.ops_done, rc, get1(w.ops_done, rc) + 1, fin_op)

    emits = _emits(dst, (rt, K_MSG, _pay(src, rmt, SERVER, ra, rb, rkey), reply_on), None)
    w2 = w._replace(
        ver_com=ver_com2,
        len_com=len_com2,
        ver_dur=ver_dur2,
        len_dur=len_dur2,
        last_acked_ver=last_acked2,
        max_served_ver=max_served2,
        gen_ctr=gen_ctr2,
        mp_gen=mp_gen2,
        mp_key=mp_key2,
        mp_mask=mp_mask2,
        mp_done_gen=mp_done_gen2,
        phase=phase2,
        cur_gen=cur_gen2,
        cur_part=cur_part2,
        ops_done=ops_done2,
        vio_regress=w.vio_regress | regress,
        violation=w.violation | regress,
        puts=w.puts + _n(is_put),
        gets=w.gets + _n(is_get),
        dels=w.dels + _n(is_del),
        creates=w.creates + _n(do_register),
        parts_recv=w.parts_recv + _n(fresh_part),
        completes=w.completes + _n(do_assemble),
        upload_restarts=w.upload_restarts + _n(got_err),
        msgs_sent=w.msgs_sent + _n(did_req),
        msgs_delivered=w.msgs_delivered + _n(reply_on),
    )
    return w2, emits


def _on_flush(cfg: S3Config, w: S3State, now, pay, rand):
    """Advance the durable tier to the committed tier (bug mode's only
    durability point) and re-arm; a slow-disk window freezes the durable
    tier while the timer ticks on."""
    gen = pay[:, 0]
    valid = efaults.up(w.fstate)[:, SERVER] & (gen == w.sgen)
    do_flush = valid & ~efaults.stalled(w.fstate)[:, SERVER]
    w2 = w._replace(
        ver_dur=torch.where(do_flush[:, None], w.ver_com, w.ver_dur),
        len_dur=torch.where(do_flush[:, None], w.len_com, w.len_dur),
    )
    flush_dt = efaults.skewed_delay(
        fault_spec(cfg), w.fstate, _node(SERVER, gen), cfg.flush_interval_ns, rt=_rt(cfg, w)
    )
    return w2, _emits(gen, (now + flush_dt, K_FLUSH, _pay(gen), valid), None)


def _on_fault(cfg: S3Config, w: S3State, now, pay, rand):
    """One event of the compiled fault campaign. For the server a crash
    rolls the committed tier back to the durable tier and aborts every
    staged upload (the ack-loss checker's moment), a crash or pause
    kills the flush-timer chain (``sgen`` bump), and a restart or resume
    re-arms it in bug mode (correct mode has no flush chain)."""
    action, victim = pay[:, 0], pay[:, 1]
    base = efaults.NetBase(cfg.lat_lo_ns, cfg.lat_hi_ns, cfg.loss_q32)
    links2, f2, e = efaults.on_event(_rt(cfg, w), base, w.links, w.fstate, action, victim)
    at_server = victim == SERVER
    crashed = e.crashed & at_server
    stopped = (e.crashed | e.paused) & at_server
    revived = (e.restarted | e.resumed) & at_server

    lost = (w.last_acked_ver > w.ver_dur).any(dim=1)
    sgen2 = w.sgen + _n(stopped)
    cr = crashed[:, None]
    w2 = w._replace(
        links=links2,
        fstate=f2,
        sgen=sgen2,
        ver_com=torch.where(cr, w.ver_dur, w.ver_com),
        len_com=torch.where(cr, w.len_dur, w.len_com),
        mp_gen=torch.where(cr, 0, w.mp_gen),
        mp_done_gen=torch.where(cr, 0, w.mp_done_gen),
        vio_ack_loss=w.vio_ack_loss | (crashed & lost),
        violation=w.violation | (crashed & lost),
        crash_count=w.crash_count + _n(crashed),
    )
    rearm = revived if cfg.bug_ack_before_durable else torch.zeros_like(revived)
    emits = _emits(action, (now + cfg.flush_interval_ns, K_FLUSH, _pay(sgen2), rearm), None)
    return w2, emits


_BRANCHES = (_on_op_timer, _on_msg, _on_flush, _on_fault)


def _handle(cfg: S3Config, w: S3State, now, kind, pay, rand):
    return _common.switch(kind, [partial(br, cfg) for br in _BRANCHES], w, now, pay, rand)


def _init(cfg: S3Config, key: torch.Tensor, params=None):
    """Batched initial state and event set from key words ``[S, 2]``;
    ``params`` are the lanes' ``FaultParams`` when ``cfg.faults`` is a
    ``FaultEnvelope``."""
    nc, k = cfg.num_clients, cfg.num_keys
    s, dev = key.shape[0], key.device
    # init draws live in their own counter namespace (0x7FFF_FFFF), as
    # 32-bit words held in int64
    rand = bits(fold_in(key, 0x7FFF_FFFF), nc + 1)
    nn = cfg.num_nodes

    def z(shape, dtype, fill=0):
        return torch.full((s,) + shape, fill, dtype=dtype, device=dev)

    w = S3State(
        fstate=efaults.init_state(s, nn, device=dev),
        sgen=z((), I32),
        ver_com=z((k,), I32),
        len_com=z((k,), I32, -1),
        ver_dur=z((k,), I32),
        len_dur=z((k,), I32, -1),
        last_acked_ver=z((k,), I32),
        max_served_ver=z((k,), I32),
        gen_ctr=z((), I32),
        mp_gen=z((nc,), I32),
        mp_key=z((nc,), I32),
        mp_mask=z((nc,), I32),
        mp_done_gen=z((nc,), I32),
        phase=z((nc,), I32),
        cur_key=z((nc,), I32),
        cur_len=z((nc,), I32),
        cur_gen=z((nc,), I32),
        cur_part=z((nc,), I32),
        ops_done=z((nc,), I32),
        links=enet.make(
            s, nn, cfg.loss_q32, cfg.lat_lo_ns, cfg.lat_hi_ns, cfg.buggify_q32, device=dev
        ),
        violation=z((), torch.bool),
        vio_ack_loss=z((), torch.bool),
        vio_regress=z((), torch.bool),
        puts=z((), I32),
        gets=z((), I32),
        dels=z((), I32),
        creates=z((), I32),
        parts_recv=z((), I32),
        completes=z((), I32),
        upload_restarts=z((), I32),
        crash_count=z((), I32),
        msgs_sent=z((), I32),
        msgs_delivered=z((), I32),
        frt=efaults.make_rt(fault_spec(cfg), params),
    )
    # one op timer per client, then the first flush tick (enabled in bug
    # mode only)
    times = [bounded(rand[:, c], 0, cfg.op_hi_ns) for c in range(nc)]
    times.append(z((), torch.int64, cfg.flush_interval_ns))
    kinds = [K_OP] * nc + [K_FLUSH]
    pays = [_pay(z((), I32, c)) for c in range(nc)] + [_pay(z((), I32, 0))]
    enables = torch.ones((s, nc + 1), dtype=torch.bool, device=dev)
    if not cfg.bug_ack_before_durable:
        enables[:, nc] = False
    fe = efaults.compile_device(fault_spec(cfg), nn, key, K_FAULT, PAYLOAD_SLOTS, params=params)
    return w, Emits(
        times=torch.cat([torch.stack(times, dim=1), fe.times], dim=1),
        kinds=torch.cat(
            [torch.tensor(kinds, dtype=I32, device=dev).expand(s, -1), fe.kinds], dim=1
        ),
        pays=torch.cat([torch.stack(pays, dim=1), fe.pays], dim=1),
        enables=torch.cat([enables, fe.enables], dim=1),
    )


@_common.memoized_workload(S3Config)
def workload(cfg: S3Config = None) -> Workload:
    """The engine Workload for an S3 sweep configuration (memoized)."""
    return Workload(
        init=partial(_init, cfg),
        handle=partial(_handle, cfg),
        num_rand=6,
        payload_slots=PAYLOAD_SLOTS,
        max_emits=2,
    )


def engine_config(cfg: S3Config = S3Config(), **overrides) -> EngineConfig:
    """Engine parameters (the reference's queue sizing: one timer chain
    and at most one request per client, a reply per request, the flush
    chain and the fault plan)."""
    defaults = dict(
        queue_capacity=max(48, 4 * cfg.num_clients + 8 + efaults.num_events(fault_spec(cfg))),
        time_limit_ns=5_000_000_000,
        max_steps=200_000,
    )
    defaults.update(overrides)
    return EngineConfig(**defaults)


sweep_summary = _common.make_sweep_summary(
    (
        ("violations", lambda f: f.wstate.violation),
        ("ack_loss_seeds", lambda f: f.wstate.vio_ack_loss),
        ("regress_seeds", lambda f: f.wstate.vio_regress),
        ("puts", lambda f: f.wstate.puts),
        ("gets", lambda f: f.wstate.gets),
        ("dels", lambda f: f.wstate.dels),
        ("creates", lambda f: f.wstate.creates),
        ("parts", lambda f: f.wstate.parts_recv),
        ("completes", lambda f: f.wstate.completes),
        ("upload_restarts", lambda f: f.wstate.upload_restarts),
        ("crashes", lambda f: f.wstate.crash_count),
        # ops_done is per client [S, NC]: folded to the per-lane vector the
        # summary's contract (and its limit mask) needs; int64, as the
        # reference's dtype-less jnp.sum is under x64
        ("ops_done", lambda f: f.wstate.ops_done.sum(dim=-1)),
        ("msgs_sent", lambda f: f.wstate.msgs_sent),
        ("msgs_delivered", lambda f: f.wstate.msgs_delivered),
    )
)
