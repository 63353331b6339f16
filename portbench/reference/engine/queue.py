# The benchmark's plain reference: a frozen copy of madsim_tpu_torch/engine/queue.py, run on the CPU.
# A change to the program's semantics reaches it only through a change to the benchmark.
"""Bounded per-seed event queues as batched tensors (counterpart of
``madsim_tpu/engine/queue.py``).

Per seed a fixed-capacity slot table; batched over seeds:

    time : int64[S, Q]    absolute deadline, ns (INVALID_TIME when free)
    kind : int32[S, Q]    event discriminant
    pay  : int32[S, Q, P] payload slots

A slot is free iff its time is ``INVALID_TIME``. ``pop_min`` takes its
decision — the slot holding the minimum deadline, equal-time ties broken
by a murmur3 priority of ``slot * 2654435761 ^ tie`` — from the pop-min
kernel (``cuda_queue.pop_min_decision``); ``push_many`` assigns emit
``e`` to the ``e``-th free slot in ascending index, exactly as the
reference does. Overflow sets a flag instead of corrupting state.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .rng import M32, mul32

INVALID_TIME = (1 << 63) - 1
HASH_MULT = 2654435761  # Knuth multiplicative hash constant


def murmur_prio(tie: torch.Tensor, capacity: int) -> torch.Tensor:
    """``[S, Q]`` tie-break priorities ``fmix32(slot * 2654435761 ^ tie)``
    as 32-bit words in int64."""
    iota = torch.arange(capacity, dtype=torch.int64, device=tie.device)
    x = mul32(iota, HASH_MULT)[None, :] ^ (tie.to(torch.int64) & M32)[:, None]
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def pop_min_decision(time: torch.Tensor, tie: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pop decision in plain torch: minimum deadline, then the minimal
    priority among the slots at that deadline, then the first such slot
    (``argmin`` returns the first minimum)."""
    prio = murmur_prio(tie, time.shape[1])
    t = time.min(dim=1).values
    cand = time == t[:, None]
    slot = torch.where(cand, prio, 1 << 33).argmin(dim=1).to(torch.int32)
    return slot, t != INVALID_TIME


class EventQueue(NamedTuple):
    time: torch.Tensor  # int64[S, Q]; INVALID_TIME == free slot
    kind: torch.Tensor  # int32[S, Q]
    pay: torch.Tensor  # int32[S, Q, P]


def make(num_seeds: int, capacity: int, payload_slots: int, device) -> EventQueue:
    time = torch.full((num_seeds, capacity), INVALID_TIME, dtype=torch.int64, device=device)
    kind = torch.zeros((num_seeds, capacity), dtype=torch.int32, device=device)
    pay = torch.zeros((num_seeds, capacity, payload_slots), dtype=torch.int32, device=device)
    return EventQueue(time, kind, pay)


def _free(q: EventQueue) -> torch.Tensor:
    return q.time == INVALID_TIME


def push(q: EventQueue, time, kind, pay, enable) -> Tuple[EventQueue, torch.Tensor]:
    """Insert one event per seed at its first free slot (no-op where
    ``enable`` is False). Returns ``(queue', overflowed [S])``."""
    return push_many(
        q,
        torch.as_tensor(time).to(torch.int64).reshape(-1, 1),
        torch.as_tensor(kind).to(torch.int32).reshape(-1, 1),
        pay[:, None, :],
        torch.as_tensor(enable).reshape(-1, 1),
    )


def push_many(
    q: EventQueue,
    times: torch.Tensor,  # int64[S, E]
    kinds: torch.Tensor,  # int32[S, E]
    pays: torch.Tensor,  # int32[S, E, P]
    enables: torch.Tensor,  # bool[S, E]
) -> Tuple[EventQueue, torch.Tensor]:
    """Insert up to E events per seed in one dense pass: emit ``e`` goes to
    the ``e``-th free slot (the slot whose rank among free slots is
    ``e``). Returns ``(queue', overflowed [S])``."""
    E = times.shape[1]
    if E == 0:
        return q, torch.zeros(q.time.shape[:1], dtype=torch.bool, device=q.time.device)
    free = _free(q)
    # rank among free slots; int32 like the reference (torch's default
    # cumsum dtype for int32 input is int64)
    rank = torch.cumsum(free.to(torch.int32), dim=1, dtype=torch.int32) - 1
    r = rank.clamp(0, max(E - 1, 0)).to(torch.int64)
    write = free & (rank < E) & torch.gather(enables, 1, r)
    t_new = torch.gather(times, 1, r)
    k_new = torch.gather(kinds, 1, r)
    p_new = torch.gather(pays, 1, r[:, :, None].expand(-1, -1, pays.shape[2]))
    num_free = free.sum(dim=1, dtype=torch.int32)
    eidx = torch.arange(E, dtype=torch.int32, device=times.device)
    overflow = (enables & (eidx[None, :] >= num_free[:, None])).any(dim=1)
    return (
        EventQueue(
            torch.where(write, t_new, q.time),
            torch.where(write, k_new, q.kind),
            torch.where(write[:, :, None], p_new, q.pay),
        ),
        overflow,
    )


def pop_min(q: EventQueue, enable=True, tie_u32=None):
    """Remove and return each seed's earliest event; equal-time ties break
    by the per-seed draw ``tie_u32 [S]``.

    Returns ``(queue', time [S], kind [S], pay [S, P], found [S])``; an
    empty queue gives ``found=False`` and ``time=INVALID_TIME``. Where
    ``enable`` is False the queue is left untouched. ``pay`` is the chosen
    slot's payload whether or not ``found`` (the reference reads it
    without the mask)."""
    S = q.time.shape[0]
    if tie_u32 is None:
        tie_u32 = torch.zeros((S,), dtype=torch.int64, device=q.time.device)
    slot, found = pop_min_decision(q.time, tie_u32)
    idx = slot.to(torch.int64)
    lanes = torch.arange(S, device=q.time.device)
    t = q.time[lanes, idx]
    kind = torch.where(found, q.kind[lanes, idx], 0)
    pay = q.pay[lanes, idx]
    rm = found
    if not (isinstance(enable, bool) and enable):
        rm = rm & enable
    mask = (torch.arange(q.time.shape[1], device=q.time.device) == idx[:, None]) & rm[:, None]
    return (
        EventQueue(torch.where(mask, INVALID_TIME, q.time), q.kind, q.pay),
        t,
        kind,
        pay,
        found,
    )


def size(q: EventQueue) -> torch.Tensor:
    """Occupied slots per seed, int64[S] — the reference's ``jnp.sum`` of
    an int32 mask promotes to int64 under x64, so its ``qmax`` is int64."""
    return (~_free(q)).sum(dim=1)
