"""The streaming sweep: a constant-occupancy lane pool with continuous
refill (counterpart of ``madsim_tpu/engine/stream.py``).

The chunked drivers run fixed batches to completion, so a lane whose seed
finishes early idles until the slowest lane of its chunk is done. Here a
**lane pool** of ``pool_size`` lanes holds the loop state for the whole
sweep; each lane carries its own ``(seed, FaultParams, step budget)``
work item, so lanes of one pool may run different candidates. A
**round** (``_round``) advances every live lane up to ``round_steps``
events, leaving early once a refill quorum (``pool_size // 8`` lanes)
has retired while the queue still holds work. Retired lanes (done, or
their step budget spent) are captured into per-chunk result buffers on
the pool's device (one gather per leaf) and **refilled** from the work
queue by a fixed-width row re-init (``_refill_rows``). The key leaf is
already its uint32 words here, so the reference's ``_leaf_info``/
``_pool_to_host``/``_buf_state`` key handling has no counterpart.

The mesh route (``mesh=``, a ``parallel.SeedMesh``; every rank calls
with the same arguments): the pool rounds up to mesh divisibility and
rank ``r`` holds the lanes ``[r*L/n, (r+1)*L/n)``. Every rank keeps the
same host bookkeeping. A round steps the local lanes, its live count
summed over the ranks (``_round`` with ``mesh``, the reference's
``_round_sharded``), so all ranks leave it together; the ranks' ``done``
and ``ctr`` are gathered, so every rank derives the same retirements
and the same refill assignment. When lanes retire, the whole pool is
gathered for the screen and the capture, so every rank flushes the same
chunks; the host phase runs on rank 0 and its verdict is broadcast
(``parallel.mesh.rank0_host_work``); each rank re-inits its own retired
lanes through the same row refill, at their local indices.

Determinism: a lane's final state is a pure function of its work item
(the engine's per-lane masking makes neighbours invisible), results are
buffered per item and flushed as *virtual chunks* in submission order —
the same ``chunk_size`` granule, ``summarize``/``host_work``/
``merge_summaries`` discipline and so the same bytes as
``checkpoint.run_sweep_pipelined``. ``queue_order``, ``reprioritize``
and an interrupt/resume through a v9 stream snapshot change the wall
time only, never a report byte.

The budget freeze: a live lane advances ``ctr`` by exactly one per step,
so the chunked driver's global cut at ``max_steps`` steps is a per-lane
cut at ``ctr >= budget``. ``_freeze_step`` applies it per lane
(stepping an over-budget lane as done, then restoring its true ``done``
bit), so lanes of different ages and budgets share a pool and each
stays bit-identical to the chunked driver.

The quorum read: the reference's round tests the live count before every
step inside one device loop and leaves at the first step where it has
fallen to the quorum. ``_round`` reads the count on the host before
every step, so a round leaves after the reference's number of steps, and
the round and refill schedule, ``stats``, the stream's telemetry and a
mid-run snapshot's pool are the reference's (PERF.md has what the read
costs on the card).

``device=None`` means CUDA (``madsim_tpu_torch.resolve_device``); with
a mesh the pool lives on the mesh's devices.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from . import core, tree
from .core import EngineConfig, EngineState, Workload
from .ops import U32

def _freeze_step(workload: Workload, cfg: EngineConfig, s: EngineState, budget):
    """One batch step with the per-lane budget freeze: an over-budget
    lane steps as done (a bit-exact pass-through) and keeps its TRUE
    ``done`` bit, as the chunked driver leaves a budget-cut lane."""
    over = s.ctr >= budget
    s2 = core.step_batch(workload, cfg, s._replace(done=s.done | over), device=s.done.device)
    return s2._replace(done=torch.where(over, s.done, s2.done))


def _live(state: EngineState, budget, mesh=None) -> int:
    live = int((~state.done & (state.ctr < budget)).sum())
    if mesh is None:
        return live
    from ..parallel.mesh import all_sum

    return all_sum(mesh, live)


def _round(workload: Workload, cfg: EngineConfig, round_steps: int, state: EngineState,
           budget, stop_live: int, mesh=None):
    """One round: up to ``round_steps`` events for every live lane (not
    done and under its own budget), leaving after the first step at which
    the live count, read before every step, is at most ``stop_live``.
    With ``mesh`` the state and budget are the local lanes and the count
    is summed over the ranks, so every rank runs the same steps."""
    i = 0
    while i < round_steps and _live(state, budget, mesh) > stop_live:
        state = _freeze_step(workload, cfg, state, budget)
        i += 1
    return state


def _take(leaf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a pool leaf (one gather per leaf; a uint32 leaf
    is gathered as its int32 bits, which torch indexes)."""
    if leaf.dtype == U32:
        return leaf.view(torch.int32).index_select(0, idx).view(U32)
    return leaf.index_select(0, idx)


def _put_(leaf: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Write ``rows`` into rows ``idx`` of ``leaf`` in place and return
    it. Repeated indices must carry identical rows: which copy lands
    last is then immaterial."""
    if leaf._base is not None or not leaf.is_contiguous():
        # a view (an expanded leaf, a slice) may share its memory: write
        # into a copy of its own
        leaf = leaf.clone(memory_format=torch.contiguous_format)
    if leaf.dtype == U32:
        leaf.view(torch.int32).index_copy_(0, idx, rows.view(torch.int32))
    else:
        leaf.index_copy_(0, idx, rows)
    return leaf


def _refill_rows(workload: Workload, cfg: EngineConfig, state: EngineState, lanes, seeds,
                 params=None):
    """The fixed-width row refill: init exactly ``len(lanes)`` fresh
    lanes and write them into the pool's leaves at ``lanes``, in place
    (one indexed copy per leaf). A short cohort is padded with duplicates
    of its first lane; the duplicate rows carry the same (seed, params)
    and so identical values, which makes the repeated writes of one index
    deterministic."""
    dev = state.done.device
    fresh = core.init_sweep(workload, cfg, seeds, device=dev, params=params)
    idx = torch.as_tensor(np.asarray(lanes, np.int64), device=dev)
    return tree.map(lambda old, new: _put_(old, idx, new), state, fresh)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def stream_sweep(
    workload: Workload,
    cfg: EngineConfig,
    seeds,
    summarize,
    *,
    params=None,
    budgets=None,
    chunk_size: Optional[int] = None,
    pool_size: Optional[int] = None,
    round_steps: int = 256,
    host_work: Optional[Callable] = None,
    screen: Optional[Callable] = None,
    mesh=None,
    queue_order=None,
    on_chunk: Optional[Callable] = None,
    stats: Optional[dict] = None,
    ckpt_path: Optional[str] = None,
    stop_after_rounds: Optional[int] = None,
    resume_from: Optional[str] = None,
    feed: Optional[Callable[[], Optional[dict]]] = None,
    reprioritize: Optional[Callable] = None,
    telemetry=None,
    device=None,
) -> dict:
    """Sweep ``seeds`` through a constant-occupancy lane pool; returns
    the merged summary dict, byte-identical to ``run_sweep_pipelined``
    over the same ``(seeds, params, chunk_size)``.

    Work items are ``(seed, params row, budget)`` in submission order;
    ``queue_order`` (a permutation of ``range(len(seeds))``) reorders
    only their dispatch onto lanes.

    - ``params``: per-item spec-as-data tree (leading axis = items);
      ``budgets``: per-item step budgets (default ``cfg.max_steps``).
    - ``screen``: ``final -> bool[S]`` suspect mask, run once per
      retirement cohort on the pool state; the per-item bits ride to the
      flush, where ``host_work(final, lo=, n=, seeds=, suspect=,
      summary=)`` sees what the pipelined driver would hand it. A
      ``host_work`` with ``incremental = True`` is driven through
      ``submit``/``poll``/``drain`` (not under checkpointing), its
      checking polled after each round under the round time's EMA.
    - ``stats``: a caller-owned dict filled with ``rounds``, ``refills``,
      ``lanes``, ``round_steps`` and ``occupancy_mean`` after every flush
      and before every snapshot, never part of the totals.
    - ``telemetry``: duck-typed (``gauge``/``count``/``observe``/
      ``event``/``event_mix``/``sample`` and an optional ``tracer``),
      every recorder behind an ``is not None`` guard.
    - ``stop_after_rounds=R`` with ``ckpt_path`` snapshots pool, pending
      results and merged totals (the v9 stream snapshot,
      ``checkpoint.save_stream``) after R rounds of this call and returns
      the partial totals; ``resume_from=path`` continues to totals equal
      to the uninterrupted run's.
    - ``feed``: polled whenever free lanes outnumber queued items;
      returns None (drain and return) or ``{"seeds": int[m], "params":
      rows or None, "budgets": int[m] or absent}`` appended to the queue.
      Segments and the initial seeds must be multiples of ``chunk_size``;
      incompatible with ``queue_order`` and checkpointing.
    - ``reprioritize``: polled before each dispatch with the undispatched
      item indices; returns a permutation of them (or None) that replaces
      their dispatch order. Incompatible with checkpointing.
    - ``mesh``: a ``parallel.SeedMesh`` (every rank calls with the same
      arguments); the pool is sharded over its ranks (``pool_size``
      rounds up to mesh divisibility) and every rank returns the same
      totals; ``host_work`` runs on rank 0 only, its verdict broadcast.
      Its device replaces ``device``.
    - ``device=None`` means CUDA.
    """
    import time as _time

    from ..models._common import merge_summaries
    from .checkpoint import _sweep_fingerprint, params_digest

    dev = resolve_device(device) if mesh is None else mesh.device
    tracer = telemetry.tracer if telemetry is not None else None
    seeds_host = core._seed_tensor(seeds, "cpu").numpy()
    n = int(seeds_host.size)
    if n == 0:
        raise ValueError("seed batch is empty")
    if round_steps < 1:
        raise ValueError(f"round_steps must be >= 1, got {round_steps}")
    params_host = None if params is None else tree.map(_np, params)
    if chunk_size is None:
        chunk_size = core.pick_chunk_size(
            workload, cfg,
            params=None if params_host is None else tree.map(lambda a: a[0], params_host),
        )
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    multiple = 1 if mesh is None else mesh.size
    L = min(pool_size if pool_size is not None else chunk_size, n)
    L = -(-L // multiple) * multiple
    # the local lanes [lane_lo, lane_lo + lanes_here) of the pool
    lane_lo, lanes_here = (0, L) if mesh is None else mesh.shard(L)

    def local(a):
        """This rank's rows of a pool-wide host array."""
        return a if mesh is None else a[lane_lo:lane_lo + lanes_here]

    def whole(state):
        """The whole pool's state (gathered over the mesh)."""
        if mesh is None:
            return state
        from ..parallel.mesh import gather_state

        return gather_state(mesh, state)
    if mesh is not None:
        from ..parallel.mesh import rank0_host_work

        host_work = rank0_host_work(mesh, host_work)
    if stop_after_rounds is not None and ckpt_path is None:
        raise ValueError("stop_after_rounds requires ckpt_path")
    budgets_host = (
        np.full(n, cfg.max_steps, np.int32) if budgets is None else np.asarray(budgets, np.int32)
    )
    if budgets_host.shape != (n,):
        raise ValueError(f"budgets must be shape ({n},), got {budgets_host.shape}")
    order = (
        np.arange(n, dtype=np.int64) if queue_order is None
        else np.asarray(queue_order, np.int64)
    )
    if not np.array_equal(np.sort(order), np.arange(n)):
        raise ValueError("queue_order must be a permutation of range(n)")
    if feed is not None:
        if queue_order is not None:
            raise ValueError("feed is incompatible with queue_order")
        if resume_from is not None or ckpt_path is not None:
            raise ValueError("feed is incompatible with checkpointing (ckpt_path/resume_from)")
        if n % chunk_size:
            raise ValueError(
                f"with feed, the initial seeds must be a multiple of "
                f"chunk_size={chunk_size}, got {n}"
            )
    if reprioritize is not None and (resume_from is not None or ckpt_path is not None):
        raise ValueError(
            "reprioritize is incompatible with checkpointing "
            "(ckpt_path/resume_from): the dispatch order is mutable"
        )

    fp = _sweep_fingerprint(workload, cfg)
    if params is not None:
        fp += "|params" + params_digest(params)
    seeds_sha = hashlib.sha256(np.ascontiguousarray(seeds_host).tobytes()).hexdigest()
    order_sha = hashlib.sha256(np.ascontiguousarray(order).tobytes()).hexdigest()

    def pool_rows(items):
        """Per-lane params rows for an item-index vector."""
        return tree.map(lambda a: a[items].copy(), params_host)

    totals: dict = {}
    # incremental checking (off under checkpointing: a snapshot needs every
    # flushed chunk's summary final at its flush); reports are equal either way
    incr = (
        host_work is not None
        and getattr(host_work, "incremental", False)
        and ckpt_path is None
        and stop_after_rounds is None
        and resume_from is None
    )
    deferred: dict = {}  # lo -> (k, base summary) awaiting a verdict
    round_ema = 0.0
    # captured, unflushed results: per chunk, one [k_c, ...] tensor per
    # leaf on the pool's device, filled by row scatters
    pend: dict = {}  # chunk index -> per-leaf buffers
    pend_have: dict = {}  # chunk index -> bool[k_c] captured flags
    sus_buf: dict = {}  # chunk index -> bool[k_c] suspect bits
    resume_pending: dict = {}
    resume_susp: dict = {}
    rounds = refills = 0
    occ_sum = 0.0
    next_flush_lo = 0

    if resume_from is not None:
        from .checkpoint import load_stream

        like = core.init_sweep(
            workload, cfg, np.zeros(L, np.int64), device=dev,
            params=None if params_host is None else pool_rows(np.zeros(L, np.int64)),
        )
        state, resume_pending, resume_susp, meta = load_stream(resume_from, like)
        for key, want in (
            ("fingerprint", fp), ("seeds_sha", seeds_sha), ("order_sha", order_sha),
            ("chunk_size", int(chunk_size)), ("lanes", int(L)),
        ):
            if meta.get(key) != want:
                raise ValueError(
                    f"stream snapshot {resume_from} is from a different stream: "
                    f"{key}={meta.get(key)!r}, expected {want!r}"
                )
        lane_item = np.asarray(meta["lane_item"], np.int64)
        lane_budget = np.asarray(meta["lane_budget"], np.int32)
        next_q = int(meta["next_q"])
        next_flush_lo = int(meta["next_flush_lo"])
        totals = meta["totals"]
        rounds = int(meta["rounds"])
        refills = int(meta["refills"])
        occ_sum = float(meta["occ_sum"])
        pool_seeds = state.seed.cpu().numpy().copy()
        if mesh is not None:
            from ..parallel.mesh import shard_state

            state = shard_state(mesh, state)
    else:
        t = min(L, n)
        lane_item = np.full(L, -1, np.int64)
        lane_item[:t] = order[:t]
        next_q = t
        # budget 0 freezes an unassigned lane before its first event
        lane_budget = np.zeros(L, np.int32)
        lane_budget[:t] = budgets_host[order[:t]]
        pool_seeds = np.empty(L, np.int64)
        pool_seeds[:t] = seeds_host[order[:t]]
        pool_seeds[t:] = seeds_host[order[0]]
        state = None
    pool_params = (
        None if params_host is None else pool_rows(np.where(lane_item >= 0, lane_item, 0))
    )
    if state is None:
        state = core.init_sweep(
            workload, cfg, local(pool_seeds), device=dev,
            params=None if pool_params is None else tree.map(local, pool_params),
        )
    # refills write the pool in place: it owns its memory (an init leaf
    # may share a host array's)
    state = tree.map(torch.clone, state)

    template = state  # the tree structure of every flushed chunk
    n_leaves = len(tree.leaves(state))

    def capture(items, rows, sus):
        """Scatter a retirement cohort's rows (per-leaf ``[cohort, ...]``
        tensors, item order matching ``items``) into the per-chunk
        buffers: one scatter per (chunk, leaf)."""
        chunks = items // chunk_size
        for c in np.unique(chunks):
            c = int(c)
            lo = c * chunk_size
            k = min(chunk_size, n - lo)
            sel = np.nonzero(chunks == c)[0]
            pos = torch.as_tensor(items[sel] - lo, device=dev)
            if c not in pend:
                pend[c] = [torch.empty((k,) + r.shape[1:], dtype=r.dtype, device=dev)
                           for r in rows]
                pend_have[c] = np.zeros(k, bool)
                sus_buf[c] = np.zeros(k, bool)
            part = rows
            if sel.size != items.size:
                sel_t = torch.as_tensor(sel, device=dev)
                part = [_take(r, sel_t) for r in rows]
            pend[c] = [_put_(buf, pos, r) for buf, r in zip(pend[c], part)]
            pend_have[c][items[sel] - lo] = True
            if sus is not None:
                sus_buf[c][items[sel] - lo] = sus[sel]

    if resume_pending:
        its = np.fromiter(resume_pending.keys(), np.int64)
        capture(
            its,
            [torch.from_numpy(np.stack([resume_pending[int(i)][j] for i in its])).to(dev)
             for j in range(n_leaves)],
            None if screen is None
            else np.array([bool(resume_susp.get(int(i), False)) for i in its]),
        )
        resume_pending = resume_susp = {}

    def publish_stats():
        if stats is not None:
            stats.update(
                rounds=int(rounds),
                refills=int(refills),
                lanes=int(L),
                round_steps=int(round_steps),
                occupancy_mean=(occ_sum / rounds if rounds else 0.0),
            )

    def merged(flo, fk, summary, t_flush=None, f0=0.0):
        """Merge one finished chunk's summary and report it."""
        merge_summaries(totals, summary)
        if telemetry is not None:
            extra = {}
            if t_flush is not None:
                dt = _time.perf_counter() - t_flush
                telemetry.observe("stream_flush_seconds", dt,
                                  help="virtual-chunk flush (summary+host work)")
                extra["wall_s"] = round(dt, 6)
                if tracer is not None:
                    tracer.complete(f"flush lo={flo}", f0, tracer._now_us() - f0,
                                    track="host", args={"lo": flo, "k": fk})
            telemetry.count("stream_seeds_done_total", fk,
                            help="seeds flushed into the merged report")
            telemetry.event_mix(summary)
            telemetry.event("flush", lo=flo, k=fk, **extra)
        if on_chunk is not None:
            on_chunk(lo=flo, k=fk, summary=summary)
        publish_stats()

    def absorb(finished):
        """Merge finished incremental reports, in submission order."""
        for flo, extra in finished:
            fk, summary = deferred.pop(flo)
            merged(flo, fk, {**summary, **extra} if extra else summary)

    def flush_ready():
        nonlocal next_flush_lo
        while next_flush_lo < n:
            c = next_flush_lo // chunk_size
            k = min(chunk_size, n - next_flush_lo)
            if c not in pend or not pend_have[c].all():
                return
            t_flush = _time.perf_counter() if telemetry is not None else None
            f0 = tracer._now_us() if tracer is not None else 0.0
            chunk_state = tree.unflatten(template, pend.pop(c))
            pend_have.pop(c)
            sus = sus_buf.pop(c)
            summary = summarize(chunk_state)
            kwargs = dict(
                lo=next_flush_lo, n=k, seeds=seeds_host[next_flush_lo:next_flush_lo + k],
                suspect=None if screen is None else sus, summary=summary,
            )
            if incr:
                # the verdict is deferred: submit decodes and dedups now,
                # the per-round polls run the checking, absorb() merges
                host_work.submit(chunk_state, **kwargs)
                deferred[next_flush_lo] = (k, summary)
                if telemetry is not None:
                    telemetry.observe("stream_flush_seconds", _time.perf_counter() - t_flush,
                                      help="virtual-chunk flush (summary+host work)")
                    if tracer is not None:
                        tracer.complete(f"flush lo={next_flush_lo}", f0, tracer._now_us() - f0,
                                        track="host", args={"lo": next_flush_lo, "k": k})
            else:
                if host_work is not None:
                    extra = host_work(chunk_state, **kwargs)
                    if extra:
                        summary = {**summary, **extra}
                merged(next_flush_lo, k, summary, t_flush, f0)
            next_flush_lo += k

    def poll_feed():
        """Extend the open-ended queue with one fed segment; False when
        there is no feed or it is dry."""
        nonlocal n, seeds_host, budgets_host, order, params_host
        if feed is None:
            return False
        seg = feed()
        if seg is None:
            return False
        new_seeds = core._seed_tensor(seg["seeds"], "cpu").numpy()
        m = int(new_seeds.size)
        if m == 0 or m % chunk_size:
            raise ValueError(
                f"fed segment must be a non-empty multiple of chunk_size={chunk_size}, "
                f"got {m} seeds"
            )
        if (seg.get("params") is None) != (params_host is None):
            raise ValueError("fed segment params presence must match the stream's")
        nb = seg.get("budgets")
        nb = np.full(m, cfg.max_steps, np.int32) if nb is None else np.asarray(nb, np.int32)
        if nb.shape != (m,):
            raise ValueError(f"fed budgets must be shape ({m},), got {nb.shape}")
        seeds_host = np.concatenate([seeds_host, new_seeds])
        budgets_host = np.concatenate([budgets_host, nb])
        order = np.concatenate([order, np.arange(n, n + m, dtype=np.int64)])
        if params_host is not None:
            params_host = tree.map(
                lambda a, b: np.concatenate([a, _np(b)]), params_host, seg["params"]
            )
        n += m
        if telemetry is not None:
            telemetry.count("stream_feed_segments_total",
                            help="work segments fed into the running stream")
            telemetry.count("stream_feed_items_total", m,
                            help="work items fed into the running stream")
        return True

    def dispatch_free():
        """Assign free lanes from the queue (polling ``feed`` when it runs
        dry) and re-init them in fixed-width cohorts of an eighth of the
        local lanes."""
        nonlocal next_q, refills, state
        if reprioritize is not None and next_q < n:
            tail = order[next_q:].copy()
            new = reprioritize(tail)
            if new is not None:
                new = np.asarray(new, np.int64)
                if new.shape != tail.shape or not np.array_equal(np.sort(new), np.sort(tail)):
                    raise ValueError(
                        "reprioritize must return a permutation of the undispatched "
                        "item indices it was given"
                    )
                order[next_q:] = new
        while True:
            free = np.nonzero(lane_item < 0)[0]
            if free.size == 0:
                return
            if next_q >= n and not poll_feed():
                return
            take = min(int(free.size), n - next_q)
            if take == 0:
                return
            lanes_t = free[:take]
            items_t = order[next_q:next_q + take]
            next_q += take
            refills += take
            if telemetry is not None:
                telemetry.count("stream_refills_total", take,
                                help="lanes refilled from the work queue")
            lane_item[lanes_t] = items_t
            lane_budget[lanes_t] = budgets_host[items_t]
            pool_seeds[lanes_t] = seeds_host[items_t]
            if pool_params is not None:
                for p, s in zip(tree.leaves(pool_params), tree.leaves(params_host)):
                    p[lanes_t] = s[items_t]
            # each rank re-inits its own retired lanes, at their local rows
            mine = lanes_t[(lanes_t >= lane_lo) & (lanes_t < lane_lo + lanes_here)]
            w = max(1, lanes_here // 8)
            for off in range(0, mine.size, w):
                sub = mine[off:off + w]
                idx = np.concatenate([sub, np.full(w - sub.size, sub[0], sub.dtype)])
                state = _refill_rows(
                    workload, cfg, state, idx - lane_lo, pool_seeds[idx],
                    None if pool_params is None else tree.map(lambda a: a[idx], pool_params),
                )

    rounds_this_call = 0
    while True:
        flush_ready()
        if next_flush_lo >= n:
            # everything queued is flushed; only a fed segment extends it
            if not poll_feed():
                break
            dispatch_free()
            continue
        assigned = int(np.count_nonzero(lane_item >= 0))
        occ_sum += assigned / L
        if telemetry is not None:
            t_round = _time.perf_counter()
            r0 = tracer._now_us() if tracer is not None else 0.0
            telemetry.gauge("stream_occupancy", assigned / L,
                            help="assigned lanes / pool size at round start")
            telemetry.gauge("stream_queue_depth", n - next_q,
                            help="work items not yet dispatched onto lanes")
            if next_q >= n:
                telemetry.count("stream_drain_rounds_total",
                                help="rounds run after the queue went dry (drain tail)")
            telemetry.sample("stream occupancy", occupancy=assigned / L,
                             queue_depth=n - next_q)
        # while the queue has work (or a feed may bring some), leave the
        # round once a refill quorum has retired; then drain to the end
        stop = max(assigned - max(1, L // 8), 0) if (next_q < n or feed is not None) else 0
        budget_dev = torch.as_tensor(local(lane_budget), device=dev)
        t_disp = _time.perf_counter()
        state = _round(workload, cfg, round_steps, state, budget_dev, stop, mesh)
        rounds += 1
        rounds_this_call += 1
        poll_s = 0.0
        if incr:
            t_poll = _time.perf_counter()
            absorb(host_work.poll(round_ema))
            poll_s = _time.perf_counter() - t_poll
        if mesh is None:
            done, ctr = state.done.cpu().numpy(), state.ctr.cpu().numpy()
        else:
            from ..parallel.mesh import gather_rows

            done = gather_rows(mesh, state.done).cpu().numpy()
            ctr = gather_rows(mesh, state.ctr).cpu().numpy()
        if incr:
            dt = max(0.0, _time.perf_counter() - t_disp - poll_s)
            round_ema = dt if round_ema == 0.0 else 0.5 * round_ema + 0.5 * dt
        if telemetry is not None:
            telemetry.observe("stream_round_seconds", _time.perf_counter() - t_round,
                              help="device round (dispatch -> pool state on host)")
            telemetry.count("stream_rounds_total")
            if tracer is not None:
                tracer.complete(f"round {rounds}", r0, tracer._now_us() - r0, track="device",
                                args={"occupancy": assigned / L, "queue": n - next_q})
        retired = (lane_item >= 0) & (done | (ctr >= lane_budget))
        if retired.any():
            if telemetry is not None:
                telemetry.count("stream_retired_total", int(retired.sum()),
                                help="lanes retired (retirement flux)")
                telemetry.observe("stream_refill_quorum_seconds",
                                  _time.perf_counter() - t_round,
                                  help="round dispatch -> retirement cohort on host "
                                  "(refill quorum latency)")
            # one screen per cohort on the pool state: a suspect bit is a
            # pure per-lane function, so these are a chunk screen's bits
            pool = whole(state)
            susp = None if screen is None else _np(screen(pool))
            idx = np.nonzero(retired)[0]
            idx_t = torch.as_tensor(idx, device=dev)
            capture(lane_item[idx], [_take(leaf, idx_t) for leaf in tree.leaves(pool)],
                    None if susp is None else susp[idx])
            del pool
            lane_item[idx] = -1
            lane_budget[idx] = 0  # frozen until refilled
            dispatch_free()

        if stop_after_rounds is not None and rounds_this_call >= stop_after_rounds:
            flush_ready()
            if next_flush_lo >= n:
                break
            publish_stats()
            if telemetry is not None:
                telemetry.event("snapshot", rounds=int(rounds), next_flush_lo=int(next_flush_lo))
            from .checkpoint import save_stream

            # the v9 row format: item -> per-leaf host rows
            pending_rows: dict = {}
            susp_rows: dict = {}
            for c, bufs in pend.items():
                lo = c * chunk_size
                have = np.nonzero(pend_have[c])[0]
                host = [b.detach().cpu().numpy() for b in bufs]
                for p in have:
                    pending_rows[lo + int(p)] = [h[p] for h in host]
                    if screen is not None:
                        susp_rows[lo + int(p)] = bool(sus_buf[c][p])
            pool = whole(state)
            if mesh is not None and mesh.rank != 0:
                from ..parallel.mesh import all_sum

                all_sum(mesh, 0)  # rank 0 has written the snapshot
                break
            save_stream(
                ckpt_path, pool, pending=pending_rows, susp=susp_rows,
                meta={
                    "fingerprint": fp,
                    "seeds_sha": seeds_sha,
                    "order_sha": order_sha,
                    "chunk_size": int(chunk_size),
                    "lanes": int(L),
                    "lane_item": [int(x) for x in lane_item],
                    "lane_budget": [int(x) for x in lane_budget],
                    "next_q": int(next_q),
                    "next_flush_lo": int(next_flush_lo),
                    "totals": totals,
                    "rounds": int(rounds),
                    "refills": int(refills),
                    "occ_sum": float(occ_sum),
                },
            )
            if mesh is not None:
                from ..parallel.mesh import all_sum

                all_sum(mesh, 0)  # the snapshot exists for every rank
            break

    if incr:
        # settle the checking still pending after the last flush (drain
        # keeps submission order, so the totals are the sync path's)
        absorb(host_work.drain())
    publish_stats()
    return totals
