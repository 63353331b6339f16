"""The batched simulation loop (counterpart of ``madsim_tpu/engine/core.py``).

Per event and per seed, exactly as the reference's ``step_one``: draw the
event's ``num_rand + 2`` threefry words, pop the minimum deadline (the
pop-min kernel decides which slot), jump the clock to it plus 50-100 ns
of jitter, run the workload handler, push what it emits, and update the
coverage, history and event-mix planes. ``step_batch`` does that for the
whole ``[S, ...]`` batch at once: the reference's ``vmap`` becomes an
explicit leading seed axis. Finished seeds are frozen: every write is
gated by the per-seed ``take`` mask, so a lane that is not taken computes
values that never reach its state.

Every entry point takes ``device=None``, which means CUDA and raises when
no GPU is present (``madsim_tpu_torch.resolve_device``). ``params=`` on
the entry points carries per-lane spec-as-data (``faults.FaultParams``
of a ``FaultEnvelope`` workload, host numpy or tensors), which the
workload's ``init`` receives on the sweep's device.
"""

from __future__ import annotations

import contextlib
import functools
import os
from collections import OrderedDict
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

from .. import resolve_device
from . import cuda_queue
from . import queue as equeue
from . import tree
from .ops import expand, where
from .queue import EventQueue
from .rng import M32, bounded, event_bits, seed_key

# Columns of one fixed-width operation-history record:
# (client, code, key, val, opid) as int32; the engine stamps the time.
HIST_COLS = 5

# drive() reads the all-done flag back to the host once per this many
# steps instead of every step (see drive's docstring for why that is exact)
CHECK_EVERY = 64

# drive() replays a CUDA state's steps as one CUDA graph of this many
# consecutive steps (a divisor of CHECK_EVERY), and keeps the graphs of
# this many (workload, config, state layout, device) keys
GRAPH_STEPS = 8
GRAPH_CACHE = 4

_NO_SPAN = contextlib.nullcontext()


class Emits(NamedTuple):
    """Fixed-size batch of events emitted by one handler invocation."""

    times: torch.Tensor  # int64[S, E] absolute deadlines
    kinds: torch.Tensor  # int32[S, E]
    pays: torch.Tensor  # int32[S, E, P]
    enables: torch.Tensor  # bool[S, E]


def no_emits(num_seeds: int, max_emits: int, payload_slots: int, device) -> Emits:
    return Emits(
        times=torch.zeros((num_seeds, max_emits), dtype=torch.int64, device=device),
        kinds=torch.zeros((num_seeds, max_emits), dtype=torch.int32, device=device),
        pays=torch.zeros(
            (num_seeds, max_emits, payload_slots), dtype=torch.int32, device=device
        ),
        enables=torch.zeros((num_seeds, max_emits), dtype=torch.bool, device=device),
    )


class Workload(NamedTuple):
    """A batched workload: two functions over ``[S, ...]`` tensors plus
    static sizes (the reference's per-seed contract with the seed axis
    written out).

    ``init(key_words int64[S, 2][, params]) -> (wstate, Emits)``;
    ``handle(wstate, now_ns [S], kind [S], pay [S, P], rand [S, num_rand])
    -> (wstate, Emits)``; ``cover``/``probe``/``record`` as in the
    reference, batched."""

    init: Callable[..., Tuple[Any, Emits]]
    handle: Callable[..., Tuple[Any, Emits]]
    num_rand: int
    payload_slots: int
    max_emits: int
    cover: Optional[Callable[..., torch.Tensor]] = None
    cover_bits: int = 0
    probe: Optional[Callable[[Any], torch.Tensor]] = None
    record: Optional[Callable[..., Tuple[torch.Tensor, torch.Tensor]]] = None
    hist_slots: int = 0
    event_mix_kinds: int = 0


def cover_words(workload: Workload) -> int:
    """uint32 words of the per-seed coverage bitmap (0 when disabled)."""
    return (workload.cover_bits + 31) // 32


def hist_slots(workload: Workload) -> int:
    """Rows of the per-seed history buffer (0 when recording is off)."""
    return workload.hist_slots if workload.record is not None else 0


class EngineConfig(NamedTuple):
    """Static engine parameters (the reference's fields and defaults)."""

    queue_capacity: int = 64
    time_limit_ns: int = 10_000_000_000
    max_steps: int = 100_000
    jitter_lo_ns: int = 50
    jitter_hi_ns: int = 100
    # 1 = the reference's A/B queue layout with a validity plane
    # (queue.LegacyEventQueue); both give equal schedules
    legacy_queue: int = 0
    # kept for config compatibility with the reference (validated, unused)
    cond_interval: int = 16


class EngineState(NamedTuple):
    """Batched per-seed simulator state; the reference's fields in its
    order (``key`` holds the typed key's data, uint32[S, 2])."""

    seed: torch.Tensor  # int64[S]
    key: torch.Tensor  # uint32[S, 2]
    now_ns: torch.Tensor  # int64[S]
    ctr: torch.Tensor  # int32[S]
    done: torch.Tensor  # bool[S]
    overflow: torch.Tensor  # bool[S]
    qmax: torch.Tensor  # int64[S]
    cover: torch.Tensor  # uint32[S, cover_words]
    hist_rec: torch.Tensor  # int32[S, hist_slots, HIST_COLS]
    hist_t: torch.Tensor  # int64[S, hist_slots]
    hist_len: torch.Tensor  # int32[S]
    hist_overflow: torch.Tensor  # bool[S]
    queue: EventQueue
    wstate: Any
    evmix: torch.Tensor  # uint32[S, event_mix_kinds]


def _validate(workload: Workload, cfg: EngineConfig) -> None:
    if workload.max_emits > cfg.queue_capacity:
        raise ValueError(
            f"workload.max_emits ({workload.max_emits}) exceeds "
            f"queue_capacity ({cfg.queue_capacity}); every handler "
            "invocation must be able to enqueue its full emit batch"
        )
    if cfg.cond_interval < 1:
        raise ValueError(f"cond_interval must be >= 1, got {cfg.cond_interval}")


def _seed_tensor(seeds, device) -> torch.Tensor:
    if isinstance(seeds, torch.Tensor):
        return seeds.to(device=device, dtype=torch.int64).reshape(-1)
    return torch.as_tensor(np.asarray(seeds, dtype=np.int64).reshape(-1), device=device)


def params_to_device(params, device):
    """Per-lane params (numpy or tensors) as tensors on ``device``, dtypes
    kept (a uint32 leaf stays uint32, like the reference's)."""
    return tree.map(
        lambda a: a.to(device) if isinstance(a, torch.Tensor)
        else torch.from_numpy(np.array(a)).to(device),
        params,
    )


def _procs_child_guard() -> None:
    """Fail by name, not by hang, when the device tier is entered from a
    forked ``Builder(procs=N)`` sweep child: this module holds the real
    torch its child's ``sys.modules`` poison cannot reach, and CUDA
    cannot be re-initialized after a fork. The sentinel carries the
    child's pid: an exec'd descendant of a child (fresh interpreter, no
    inherited state) inherits the variable but not the pid, and may use
    the engine."""
    if os.environ.get("MADSIM_IN_PROCS_CHILD") == str(os.getpid()):
        from ..builder import ProcsDeviceTierError

        raise ProcsDeviceTierError("madsim_tpu_torch.engine")


def init_sweep(
    workload: Workload, cfg: EngineConfig, seeds, device=None, params=None
) -> EngineState:
    """Build the batched state for a seed vector (int64[S]). ``params``
    (optional) is a per-lane tree — leading axis S on every leaf, e.g.
    ``faults.tile_params`` of one candidate or a candidate x seed grid."""
    _procs_child_guard()
    dev = resolve_device(device)
    _validate(workload, cfg)
    seeds = _seed_tensor(seeds, dev)
    s = seeds.shape[0]
    words = seed_key(seeds)
    if params is None:
        wstate, emits = workload.init(words)
    else:
        wstate, emits = workload.init(words, params_to_device(params, dev))
    q = equeue.make(
        s, cfg.queue_capacity, workload.payload_slots, dev, legacy=bool(cfg.legacy_queue)
    )
    q, overflow = equeue.push_many(q, emits.times, emits.kinds, emits.pays, emits.enables)
    hs = hist_slots(workload)

    def zeros(shape, dtype):
        return torch.zeros((s,) + shape, dtype=dtype, device=dev)

    return EngineState(
        seed=seeds,
        key=words.to(torch.uint32),
        now_ns=zeros((), torch.int64),
        ctr=zeros((), torch.int32),
        done=zeros((), torch.bool),
        overflow=overflow,
        qmax=equeue.size(q),
        cover=zeros((cover_words(workload),), torch.uint32),
        hist_rec=zeros((hs, HIST_COLS), torch.int32),
        hist_t=zeros((hs,), torch.int64),
        hist_len=zeros((), torch.int32),
        hist_overflow=zeros((), torch.bool),
        queue=q,
        wstate=wstate,
        evmix=zeros((workload.event_mix_kinds,), torch.uint32),
    )


def _span(name: str):
    """A CPU-side profiler range named ``name`` while torch's profiler
    records; otherwise one flag read and no range. ``_RecordFunctionFast``
    is a function-scoped range: the profiler puts it on the host's
    timeline only, not mirrored onto the device's as a user annotation,
    so it adds no device operation to a trace."""
    return _RecordFunctionFast(name) if _profiler._is_profiler_enabled else _NO_SPAN


def _planes(workload: Workload, s: EngineState, wstate, now, kind, pay, take):
    """The coverage, history and event-mix planes after one event:
    ``(cover, hist_rec, hist_t, hist_len, hist_overflow, evmix)``."""
    dev = s.now_ns.device
    cover = s.cover
    if workload.cover is not None and workload.cover_bits > 0:
        w = cover_words(workload)
        bit = workload.cover(s.wstate, wstate, now, kind, pay).to(torch.int64) & M32
        hit = (torch.arange(w, device=dev) == (bit >> 5)[:, None]) & take[:, None]
        cover = (
            s.cover.to(torch.int64) | torch.where(hit, (1 << (bit & 31))[:, None], 0)
        ).to(torch.uint32)

    hist_rec, hist_t = s.hist_rec, s.hist_t
    hist_len, hist_ov = s.hist_len, s.hist_overflow
    if workload.record is not None and workload.hist_slots > 0:
        h = workload.hist_slots
        rec, ren = workload.record(s.wstate, wstate, now, kind, pay)
        want = take & ren
        fits = hist_len < h
        row = (torch.arange(h, device=dev) == hist_len[:, None]) & (want & fits)[:, None]
        hist_rec = torch.where(row[:, :, None], rec.to(torch.int32)[:, None, :], hist_rec)
        hist_t = torch.where(row, now[:, None], hist_t)
        hist_len = hist_len + (want & fits).to(torch.int32)
        hist_ov = hist_ov | (want & ~fits)

    evmix = s.evmix
    if workload.event_mix_kinds > 0:
        k = workload.event_mix_kinds
        slot = (torch.arange(k, dtype=torch.int32, device=dev) == kind[:, None]) & take[:, None]
        evmix = ((s.evmix.to(torch.int64) + slot.to(torch.int64)) & M32).to(torch.uint32)
    return cover, hist_rec, hist_t, hist_len, hist_ov, evmix


def _step(workload: Workload, cfg: EngineConfig, s: EngineState):
    """One event for every seed; returns ``(state', kind, pay)`` where
    ``kind``/``pay`` are the popped event's (for the traced replay).

    Six profiler ranges (``_span``) tile the step, so that every torch
    op of it runs inside exactly one: ``step.draws``, ``step.pop``,
    ``step.handler``, ``step.push``, ``step.planes``, ``step.select``."""
    # draw layout: rand[:, 0] clock jitter, rand[:, 1] pop tie-break,
    # rand[:, 2:] the handler's draws
    with _span("step.draws"):
        rand = event_bits(s.key, s.ctr, workload.num_rand + 2)
        jitter = bounded(rand[:, 0], cfg.jitter_lo_ns, cfg.jitter_hi_ns + 1)
    with _span("step.pop"):
        active = ~s.done
        q, t, kind, pay, found = equeue.pop_min(s.queue, enable=active, tie_u32=rand[:, 1])
        # an empty queue pops INVALID_TIME (int64 max), whose jump would
        # overflow; such a lane is never taken (found is False), so it jumps
        # from its own clock instead — its value reaches no state
        now = torch.maximum(s.now_ns, torch.where(found, t, s.now_ns)) + jitter
        time_up = now > cfg.time_limit_ns
        take = active & found & ~time_up
    with _span("step.handler"):
        wstate, emits = workload.handle(s.wstate, now, kind, pay, rand[:, 2:])
    with _span("step.push"):
        q, ov = equeue.push_many(
            q, emits.times, emits.kinds, emits.pays, emits.enables & take[:, None]
        )
    with _span("step.planes"):
        cover, hist_rec, hist_t, hist_len, hist_ov, evmix = _planes(
            workload, s, wstate, now, kind, pay, take)

    def sel(new, old):
        # a leaf no handler touched is the same tensor: nothing to select
        return old if new is old else where(expand(take, new.ndim), new, old)

    with _span("step.select"):
        state = EngineState(
            seed=s.seed,
            key=s.key,
            now_ns=torch.where(take, now, s.now_ns),
            ctr=torch.where(take, s.ctr + 1, s.ctr),
            done=s.done | (active & (~found | time_up)),
            overflow=s.overflow | (take & ov),
            qmax=torch.maximum(s.qmax, equeue.size(q)),
            cover=cover,
            hist_rec=hist_rec,
            hist_t=hist_t,
            hist_len=hist_len,
            hist_overflow=hist_ov,
            queue=q,
            wstate=tree.map(sel, wstate, s.wstate),
            evmix=evmix,
        )
    return state, kind, pay


def step_one(workload: Workload, cfg: EngineConfig, s: EngineState) -> EngineState:
    """Advance one seed by one event (no-op once ``done``). ``s`` is one
    lane's state with no batch axis, as the reference's ``step_one``
    takes it: the step runs as a batch of one on the state's own device."""
    one = tree.map(lambda a: a.unsqueeze(0), s)
    return tree.map(lambda a: a.squeeze(0), _step(workload, cfg, one)[0])


def step_batch(
    workload: Workload, cfg: EngineConfig, state: EngineState, device=None
) -> EngineState:
    """One lockstep event for every live seed in the batch (one pop-min
    kernel launch on the GPU). ``state`` must live on ``device`` (None
    means CUDA), so a CPU state is stepped only when asked for by name."""
    dev = resolve_device(device)
    if state.now_ns.device.type != dev.type:
        raise ValueError(f"state lives on {state.now_ns.device}, not on {dev}")
    return _step(workload, cfg, state)[0]


def _steps_into(workload: Workload, cfg: EngineConfig, static: EngineState, n: int) -> None:
    """``n`` consecutive steps of the state ``static``, written back into
    its own leaves: the body a step graph captures. ``_step`` returns each
    leaf either as the same tensor (``seed``, ``key``, a field no handler
    touched), which is not copied, or as a new one (its selects), so no
    copy overwrites a buffer another copy still reads."""
    s = static
    for _ in range(n):
        s = _step(workload, cfg, s)[0]
    ins, outs = tree.leaves(static), tree.leaves(s)
    if len(ins) != len(outs) or any(
            o.shape != i.shape or o.dtype != i.dtype for i, o in zip(ins, outs)):
        raise ValueError("the step changed its state's layout: it cannot be replayed in place")
    for i, o in zip(ins, outs):
        if o is not i:
            i.copy_(o)


def _layout(x):
    """A state tree's structure with each leaf's shape and dtype."""
    if isinstance(x, tuple):
        return type(x), tuple(_layout(c) for c in x)
    return None if x is None else (tuple(x.shape), x.dtype)


def _identity(x):
    """What two workloads built alike share, for a cache key: a
    ``functools.partial`` (how every model binds its config into its
    functions) as its function and arguments, anything else as itself."""
    if isinstance(x, functools.partial):
        return (x.func, tuple(map(_identity, x.args)),
                tuple(sorted((k, _identity(v)) for k, v in x.keywords.items())))
    return x


class _StepGraph:
    """``GRAPH_STEPS`` consecutive steps captured as one CUDA graph over
    static state buffers (``_steps_into``). Capturing runs no kernel, so
    it advances no lane. The pop-min launches the capture takes in
    (``cuda_queue.pop_min_decision.captured``) must be one a step; each
    replay adds them to ``pop_min_decision.launches``, the kernels it ran."""

    device_type = "cuda"  # the states it captures

    def __init__(self, workload: Workload, cfg: EngineConfig, state: EngineState):
        self.static = tree.map(torch.empty_like, state)
        captured = cuda_queue.pop_min_decision.captured
        self.graph = self._capture(
            lambda: _steps_into(workload, cfg, self.static, GRAPH_STEPS), state.now_ns.device)
        self.launches = cuda_queue.pop_min_decision.captured - captured
        if self.launches != GRAPH_STEPS:
            self.graph.reset()
            raise RuntimeError(f"the step graph took in {self.launches} pop-min launches for "
                               f"its {GRAPH_STEPS} steps, not one a step")
        drive.captures += 1

    @staticmethod
    def _capture(body: Callable[[], None], device: torch.device):
        # captured on the state's card, whichever is current
        with torch.cuda.device(device):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                body()
        return graph

    def load(self, state: EngineState) -> EngineState:
        """Copy ``state`` into the static buffers; returns them."""
        for dst, src in zip(tree.leaves(self.static), tree.leaves(state)):
            dst.copy_(src)
        return self.static

    def replay(self, times: int) -> None:
        """``times * GRAPH_STEPS`` steps of the static state."""
        for _ in range(times):
            self.graph.replay()
        cuda_queue.pop_min_decision.launches += times * self.launches
        drive.graph_steps += times * GRAPH_STEPS

    def unload(self) -> EngineState:
        """A copy of the static state: a later replay cannot reach it."""
        return tree.map(torch.clone, self.static)


_GRAPHS: "OrderedDict[tuple, _StepGraph]" = OrderedDict()


def _step_graph(workload: Workload, cfg: EngineConfig,
                state: EngineState) -> Optional[_StepGraph]:
    """The cached step graph of this workload (``_identity``: built
    alike, not the same object), config (``max_steps`` aside: a step
    never reads it), state layout and device, captured on a miss (None
    for a state off CUDA). Before a capture, the least recently used
    graphs beyond ``GRAPH_CACHE - 1`` are dropped and their memory pools
    released."""
    if state.now_ns.device.type != _StepGraph.device_type:
        return None
    key = (tuple(map(_identity, workload)), cfg._replace(max_steps=0), _layout(state),
           state.now_ns.device)
    g = _GRAPHS.get(key)
    if g is not None:
        _GRAPHS.move_to_end(key)
        return g
    while len(_GRAPHS) >= GRAPH_CACHE:
        _GRAPHS.popitem(last=False)[1].graph.reset()
    g = _GRAPHS[key] = _StepGraph(workload, cfg, state)
    return g


def release_step_graphs() -> None:
    """Drop every cached step graph: their static states and memory pools
    go back to torch's allocator (``torch.cuda.empty_cache`` returns them
    to the card). The next ``drive`` of a CUDA state captures anew."""
    while _GRAPHS:
        _GRAPHS.popitem(last=False)[1].graph.reset()


class StepCount:
    """The engine steps run while it is entered (``with StepCount() as
    c``, or ``start()`` and ``stop()``), and pop-min's kernels over them:

    - ``batched``: ``step_batch`` calls and the steps ``drive``'s step
      graphs replayed;
    - ``steps``: every step, the ``_step`` calls made outside a capture
      (``run_traced`` steps without ``step_batch``) and the replayed steps;
    - ``launches``: the change of ``pop_min_decision.launches``, counted
      where the kernel is launched (a replay adds the launches its capture
      took in);
    - ``captures``: the step graphs captured; the ``_step`` calls seen
      while they were captured must be ``GRAPH_STEPS`` each.

    On a card every step launches the kernel once: ``launches == steps``."""

    def start(self) -> "StepCount":
        global step_batch, _step
        calls, eager, captured = [0], [0], [0]
        batch_fn, step_fn = step_batch, _step
        cuda = torch.cuda.is_available()

        def counted_batch(*args, **kwargs):
            calls[0] += 1
            return batch_fn(*args, **kwargs)

        def counted_step(*args, **kwargs):
            if cuda and torch.cuda.is_current_stream_capturing():
                captured[0] += 1
            else:
                eager[0] += 1
            return step_fn(*args, **kwargs)

        self._restore = lambda: globals().update(step_batch=batch_fn, _step=step_fn)
        self._counts = calls, eager, captured
        self._base = (drive.graph_steps, drive.captures, cuda_queue.pop_min_decision.launches)
        step_batch, _step = counted_batch, counted_step
        return self

    def stop(self) -> "StepCount":
        self._restore()
        (calls, eager, captured), base = self._counts, self._base
        graphed, self.captures, self.launches = (
            b - a for a, b in zip(base, (drive.graph_steps, drive.captures,
                                         cuda_queue.pop_min_decision.launches)))
        if captured[0] != self.captures * GRAPH_STEPS:
            raise RuntimeError(f"{self.captures} step graphs captured {captured[0]} steps, not "
                               f"{GRAPH_STEPS} each")
        self.batched, self.steps = calls[0] + graphed, eager[0] + graphed
        return self

    __enter__ = start

    def __exit__(self, kind, *exc) -> None:
        if kind is None:
            self.stop()
        else:
            self._restore()


def drive(workload: Workload, cfg: EngineConfig, state: EngineState,
          live: Optional[Callable[[EngineState], int]] = None) -> EngineState:
    """Step a batched state until every seed is done or ``cfg.max_steps``
    steps have run.

    The reference tests ``any(~done)`` before every step. Here the host
    reads the live count (``live(state)``; default the state's own
    not-done lanes) once per ``CHECK_EVERY`` steps, so the GPU is not
    synchronised every event. That is bit-identical: a done lane is a
    frozen no-op (its pop and pushes are disabled and every write is
    gated by ``take``), so the extra steps after the last seed finishes
    change nothing — and the step count never exceeds ``max_steps``. The
    seed mesh passes the count summed over its ranks, so every rank runs
    the same steps.

    A CUDA state is copied once into the static buffers of a step graph
    (``_step_graph``: the same ``_step``, kernels and order, captured
    once per workload, config, state layout and device) and stepped by
    replaying it, ``CHECK_EVERY / GRAPH_STEPS`` times between reads; the
    ``n % GRAPH_STEPS`` steps of a last block cut short by ``max_steps``
    run eagerly on a copy. A step that cannot be captured raises. The
    result is a copy, never a graph's buffer, so a later ``drive`` call
    leaves it as it is. A CPU state is stepped eagerly."""
    if live is None:
        live = lambda s: int((~s.done).sum())  # noqa: E731
    graph = None
    steps = 0
    while steps < cfg.max_steps and live(state) > 0:
        n = min(CHECK_EVERY, cfg.max_steps - steps)
        if steps == 0 and n >= GRAPH_STEPS:
            graph = _step_graph(workload, cfg, state)
            if graph is not None:
                state = graph.load(state)
        eager = n
        if graph is not None:
            graph.replay(n // GRAPH_STEPS)
            eager = n % GRAPH_STEPS
            if eager:
                state, graph = graph.unload(), None
        # stepped in this frame, so each step's input state is freed as
        # the next one starts (a helper's caller would hold the first)
        for _ in range(eager):
            state = step_batch(workload, cfg, state, device=state.now_ns.device)
        steps += n
        drive.steps += n
    return state if graph is None else graph.unload()


# steps ``drive`` has run in this process, those of them served by
# step-graph replays, and the step graphs it captured, counted on the
# host (the pipelined driver reads the first two around each chunk's
# sweep; ``compiles.count_compiles`` the captures)
drive.steps = 0
drive.graph_steps = 0
drive.captures = 0


def run_sweep(
    workload: Workload, cfg: EngineConfig, seeds, device=None, params=None
) -> EngineState:
    """Run a whole seed batch to completion; returns the final batched
    state (workload stats live in ``.wstate``). ``params`` carries
    per-lane spec-as-data (see ``init_sweep``)."""
    return drive(workload, cfg, init_sweep(workload, cfg, seeds, device=device, params=params))


def lane_slice(state, n: int, lo: int):
    """Lanes ``[lo, lo + n)`` of a batched state tree (the grid path
    carves one candidate's lanes out of a flat sweep with this)."""
    return tree.map(lambda a: a.narrow(0, int(lo), n), state)


def _slice_params(params, lo: int, hi: int):
    """Per-lane params for one chunk's lane slice."""
    return tree.map(lambda a: a[lo:hi], params)


def _pad_seeds(seeds: torch.Tensor, pad: int) -> torch.Tensor:
    """Append ``pad`` synthetic continuation seeds (max real seed + 1 +
    i); their lanes are trimmed by ``_concat_finals`` or masked by a
    ``limit=`` summary."""
    filler = seeds.max() + 1 + torch.arange(pad, dtype=torch.int64, device=seeds.device)
    return torch.cat([seeds, filler])


def _pad_params(params, pad: int):
    """Edge-replicate per-lane params (numpy or tensors) for ``pad``
    synthetic lanes: any valid params do, and the last lane's are there."""

    def edge(a):
        if isinstance(a, torch.Tensor):
            return torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))])
        a = np.asarray(a)
        return np.concatenate([a, np.broadcast_to(a[-1:], (pad,) + a.shape[1:])])

    return tree.map(edge, params)


def _concat_finals(total: int, *finals):
    """Concatenate chunk finals along the seed axis and trim the padded
    lanes: the first ``total`` lanes."""
    return tree.map(lambda *ls: torch.cat(ls, dim=0)[:total], *finals)


def run_padded(run_chunk, seeds: torch.Tensor, lo: int, chunk_size: int, pad: int, params):
    """``run_chunk`` over the chunk of ``seeds`` (and per-lane ``params``)
    at ``lo``, padded by ``pad`` synthetic lanes."""
    chunk = seeds[lo : lo + chunk_size]
    if pad:
        chunk = _pad_seeds(chunk, pad)
    if params is None:
        return run_chunk(chunk)
    pchunk = _slice_params(params, lo, lo + chunk_size)
    if pad:
        pchunk = _pad_params(pchunk, pad)
    return run_chunk(chunk, pchunk)


def run_in_chunks(run_chunk, seeds, chunk_size: int, multiple: int = 1, params=None):
    """Run ``run_chunk(seed_chunk)`` over sequential ``chunk_size`` slices,
    each padded to the next ``multiple`` of lanes, and concatenate the
    final states with the padded lanes trimmed off. With per-lane
    ``params``, ``run_chunk(seed_chunk, param_chunk)`` receives the
    matching slice, edge-padded like the seeds.

    A ragged final chunk is not padded to the full ``chunk_size``: the
    reference does so only to reuse one compiled XLA program, and an
    eager step has none to reuse."""
    seeds = _seed_tensor(seeds, "cpu")
    n = int(seeds.shape[0])
    if n == 0:
        raise ValueError("seed batch is empty")
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    finals = [
        run_padded(run_chunk, seeds, lo, chunk_size,
                   -min(chunk_size, n - lo) % multiple, params)
        for lo in range(0, n, chunk_size)
    ]
    return _concat_finals(n, *finals)


def _one_lane(params):
    """One candidate's unbatched params with a lane axis of 1."""
    return None if params is None else tree.map(lambda a: a[None], params)


def state_bytes_per_seed(workload: Workload, cfg: EngineConfig, params=None) -> int:
    """Loop-carry bytes one seed lane holds (the key counts its two
    uint32 words), from one lane's initial state built on the CPU.
    ``params`` is one lane's (unbatched) spec-as-data tree for an
    envelope workload, whose carry holds the lane's ``FaultRt``."""
    one = init_sweep(workload, cfg, [0], device="cpu", params=_one_lane(params))
    return sum(leaf.numel() * leaf.element_size() for leaf in tree.leaves(one))


# The reference's loop-carry budget for an auto-picked chunk: chosen for
# the TPU (its batch curve's occupancy knee, docs/pallas_finding.md), not
# measured on the H100. Pass ``budget_bytes`` to override it.
DEFAULT_CHUNK_BUDGET_BYTES = 128 * 1024 * 1024


def pick_chunk_size(
    workload: Workload,
    cfg: EngineConfig,
    budget_bytes: int = DEFAULT_CHUNK_BUDGET_BYTES,
    lo: int = 1024,
    hi: int = 65536,
    params=None,
) -> int:
    """Largest power-of-two batch in ``[lo, hi]`` whose loop carry fits
    ``budget_bytes`` (the reference's rule); ``params`` is one lane's
    unbatched spec-as-data tree."""
    per_seed = max(1, state_bytes_per_seed(workload, cfg, params=params))
    size = lo
    while size * 2 <= hi and size * 2 * per_seed <= budget_bytes:
        size *= 2
    return size


def run_sweep_chunked(
    workload: Workload,
    cfg: EngineConfig,
    seeds,
    chunk_size: Optional[int] = None,
    device=None,
    params=None,
) -> EngineState:
    """Run a large sweep as sequential ``chunk_size`` batches and
    concatenate the final states — bit-identical per seed to one big
    ``run_sweep`` (seeds are independent). ``chunk_size=None`` picks one
    with ``pick_chunk_size``; per-lane ``params`` are sliced per chunk."""
    dev = resolve_device(device)
    if chunk_size is None:
        chunk_size = pick_chunk_size(
            workload, cfg,
            params=None if params is None else tree.map(lambda a: a[0], params),
        )
    if params is None:
        return run_in_chunks(
            lambda chunk: run_sweep(workload, cfg, chunk, device=dev), seeds, chunk_size
        )
    return run_in_chunks(
        lambda chunk, pchunk: run_sweep(workload, cfg, chunk, device=dev, params=pchunk),
        seeds, chunk_size, params=params,
    )


def run_traced(workload: Workload, cfg: EngineConfig, seed: int, device=None, params=None):
    """Replay ONE seed, recording every dispatched event in order; returns
    ``(final, trace)`` like the reference (``final`` without the seed
    axis; ``trace`` arrays of length ``cfg.max_steps``: ``time_ns``,
    ``kind``, ``pay``, ``fired`` and, when the workload has a probe,
    ``probe`` — the violation flavors after each step).

    The reference scans all ``max_steps`` steps. Once the seed is done
    every further step is a frozen no-op that records ``(-1, -1, 0,
    False)`` and the final state's probe, so the loop stops there and
    the remaining entries are filled with exactly those values.

    ``params`` is ONE candidate's (unbatched) spec-as-data tree."""
    dev = resolve_device(device)
    state = init_sweep(workload, cfg, [seed], device=dev, params=_one_lane(params))
    total = cfg.max_steps
    p = workload.payload_slots
    times, kinds, pays, fired, probes = [], [], [], [], []

    def probe_of(st):
        if workload.probe is None:
            return torch.zeros((1,), dtype=torch.int32, device=dev)
        return workload.probe(st.wstate).to(torch.int32)

    steps = 0
    while steps < total and not bool(state.done.all()):
        for _ in range(min(CHECK_EVERY, total - steps)):
            before = state.ctr
            state, kind, pay = _step(workload, cfg, state)
            f = state.ctr > before
            times.append(torch.where(f, state.now_ns, -1))
            kinds.append(torch.where(f, kind, -1))
            pays.append(torch.where(f[:, None], pay, 0))
            fired.append(f)
            probes.append(probe_of(state))
            steps += 1
    rest = total - steps
    if rest:
        times.append(torch.full((rest,), -1, dtype=torch.int64, device=dev))
        kinds.append(torch.full((rest,), -1, dtype=torch.int32, device=dev))
        pays.append(torch.zeros((rest, p), dtype=torch.int32, device=dev))
        fired.append(torch.zeros((rest,), dtype=torch.bool, device=dev))
        probes.append(probe_of(state).expand(rest))
    trace = {
        "time_ns": torch.cat(times),
        "kind": torch.cat(kinds),
        "pay": torch.cat(pays),
        "fired": torch.cat(fired),
    }
    if workload.probe is not None:
        trace["probe"] = torch.cat(probes)
    return tree.map(lambda a: a[0], state), trace
