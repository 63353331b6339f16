"""The batched simulation loop of the plain reference: a frozen copy of
``madsim_tpu_torch/engine/core.py``'s state, init and step, on the CPU.

The pop decision is the plain torch one (``queue.pop_min_decision``);
no kernel is built or launched. ``time_bits=32`` (the benchmark's
control) holds every clock value and deadline in 32 bits, wrapping as
an int32 nanosecond clock would.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import queue as equeue
from . import tree
from .ops import expand, where
from .queue import EventQueue
from .rng import M32, bounded, event_bits, seed_key

# Columns of one fixed-width operation-history record:
# (client, code, key, val, opid) as int32; the engine stamps the time.
HIST_COLS = 5


def wrap_time(x: torch.Tensor, time_bits: int) -> torch.Tensor:
    """``x`` as a ``time_bits``-bit two's-complement value (64: unchanged)."""
    if time_bits == 64:
        return x
    half = 1 << (time_bits - 1)
    return ((x + half) & ((1 << time_bits) - 1)) - half


class Emits(NamedTuple):
    """Fixed-size batch of events emitted by one handler invocation."""

    times: torch.Tensor  # int64[S, E] absolute deadlines
    kinds: torch.Tensor  # int32[S, E]
    pays: torch.Tensor  # int32[S, E, P]
    enables: torch.Tensor  # bool[S, E]


class Workload(NamedTuple):
    """A batched workload: two functions over ``[S, ...]`` tensors plus
    static sizes (the reference's per-seed contract with the seed axis
    written out).

    ``init(key_words int64[S, 2]) -> (wstate, Emits)``;
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
    # the program's A/B queue layout switch; the reference has the one
    # layout it gives equal schedules to, so only 0 is run here
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
    if cfg.legacy_queue:
        raise ValueError("the reference runs legacy_queue=0 only")
    if cfg.cond_interval < 1:
        raise ValueError(f"cond_interval must be >= 1, got {cfg.cond_interval}")


def _seed_tensor(seeds, device) -> torch.Tensor:
    if isinstance(seeds, torch.Tensor):
        return seeds.to(device=device, dtype=torch.int64).reshape(-1)
    return torch.as_tensor(np.asarray(seeds, dtype=np.int64).reshape(-1), device=device)


def init_sweep(workload: Workload, cfg: EngineConfig, seeds, time_bits: int = 64) -> EngineState:
    """The batched state of a seed vector (int64[S]) on the CPU."""
    _validate(workload, cfg)
    dev = torch.device("cpu")
    seeds = _seed_tensor(seeds, dev)
    s = seeds.shape[0]
    words = seed_key(seeds)
    wstate, emits = workload.init(words)
    q = equeue.make(s, cfg.queue_capacity, workload.payload_slots, dev)
    q, overflow = equeue.push_many(
        q, wrap_time(emits.times, time_bits), emits.kinds, emits.pays, emits.enables
    )
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


def _step(workload: Workload, cfg: EngineConfig, s: EngineState, time_bits: int = 64):
    """One event for every seed; returns ``(state', kind, pay)``.
    ``time_bits=32`` holds every clock value and deadline in 32 bits."""
    dev = s.now_ns.device
    active = ~s.done
    # draw layout: rand[:, 0] clock jitter, rand[:, 1] pop tie-break,
    # rand[:, 2:] the handler's draws
    rand = event_bits(s.key, s.ctr, workload.num_rand + 2)
    q, t, kind, pay, found = equeue.pop_min(s.queue, enable=active, tie_u32=rand[:, 1])
    jitter = bounded(rand[:, 0], cfg.jitter_lo_ns, cfg.jitter_hi_ns + 1)
    # an empty queue pops INVALID_TIME (int64 max), whose jump would
    # overflow; such a lane is never taken (found is False), so it jumps
    # from its own clock instead — its value reaches no state
    now = wrap_time(torch.maximum(s.now_ns, torch.where(found, t, s.now_ns)) + jitter, time_bits)
    time_up = now > cfg.time_limit_ns
    take = active & found & ~time_up

    wstate, emits = workload.handle(s.wstate, now, kind, pay, rand[:, 2:])
    q, ov = equeue.push_many(
        q, wrap_time(emits.times, time_bits), emits.kinds, emits.pays,
        emits.enables & take[:, None],
    )

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

    def sel(new, old):
        # a leaf no handler touched is the same tensor: nothing to select
        return old if new is old else where(expand(take, new.ndim), new, old)

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


def step(workload: Workload, cfg: EngineConfig, state: EngineState, time_bits: int = 64) -> EngineState:
    """One lockstep event for every live seed."""
    return _step(workload, cfg, state, time_bits)[0]
