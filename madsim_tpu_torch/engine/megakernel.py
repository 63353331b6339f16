"""The resident multi-step sweep of the probe workload (counterpart of
``madsim_tpu/engine/megakernel.py``).

The probe workload has the MadRaft step's structural shape — a 58-slot
queue, 8 payload words, 15 draws per event, a 7-wide emit batch and a
``[5, 32]`` masked-write ring — with an integer-only handler, so the
engine's step and a hand-written kernel can run the same events and be
compared leaf for leaf.

- ``probe_workload()`` / ``probe_config(max_steps)``: the workload,
  batched over ``[S, ...]`` like every port ``Workload``, and its engine
  configuration (a horizon no seed reaches).
- ``run_megasweep_ref(state, steps, time_limit)``: the plain version —
  ``core.step_batch`` exactly ``steps`` times (equal to ``core.drive``
  with ``max_steps=steps``, since a done seed is a frozen no-op).
- ``run_megasweep_counted(state, steps, time_limit)``: the plain
  version's loop, also counting the work its events needed (events,
  taken events, tied pops, the slots at tied minima, live-slot visits),
  from which ``chip_smoke.py`` computes the kernel's bound.
- ``run_megasweep(state, steps, time_limit, tile)``: ``steps`` events per
  seed in one launch of ``csrc/megasweep.cu`` over the whole batch on a
  CUDA state (one thread per seed, its queue in shared memory for all
  ``steps`` events); the plain version on a CPU state.
  ``run_megasweep.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import cuda_megasweep
from .core import Emits, EngineConfig, EngineState, Workload, step_batch
from .cuda_queue import INVALID_TIME
from .rng import M32, bounded

_N = 5  # nodes (raft parity)
_L = 32  # log slots per node
_Q = 58  # queue capacity (raft config #3)
_P = 8  # payload slots
_NUM_RAND = 13  # raft: 2N+3
_MAX_EMITS = 7  # raft: N+2
_DELAY_LO = 1_000_000  # 1 ms
_DELAY_HI = 20_000_001  # 20 ms

I32 = torch.int32


class _ProbeW(NamedTuple):
    ring: torch.Tensor  # int32[S, N, L] — the raft log-write analogue
    acc: torch.Tensor  # int32[S] rolling mix of draws
    nsent: torch.Tensor  # int32[S] events handled


def _i32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit word (int64 in [0, 2**32)) as the int32 of the same bits."""
    return (((x & M32) ^ 0x80000000) - 0x80000000).to(I32)


def _probe_init(key: torch.Tensor) -> Tuple[_ProbeW, Emits]:
    """Deterministic init (no draws): N live timers, one per node."""
    s, dev = key.shape[0], key.device
    w = _ProbeW(
        ring=torch.zeros((s, _N, _L), dtype=I32, device=dev),
        acc=torch.zeros((s,), dtype=I32, device=dev),
        nsent=torch.zeros((s,), dtype=I32, device=dev),
    )
    e = torch.arange(_MAX_EMITS, dtype=torch.int64, device=dev)
    pays = torch.zeros((s, _MAX_EMITS, _P), dtype=I32, device=dev)
    pays[:, :, 0] = (e % _N).to(I32)
    return w, Emits(
        times=((e + 1) * 1_000_000).expand(s, -1).contiguous(),
        kinds=torch.zeros((s, _MAX_EMITS), dtype=I32, device=dev),
        pays=pays,
        enables=(e < _N).expand(s, -1).contiguous(),
    )


def _probe_handle(w: _ProbeW, now, kind, pay, rand) -> Tuple[_ProbeW, Emits]:
    """One event per seed: mix draws into the accumulator, one masked ring
    write, re-arm one timer on a random node."""
    del kind
    s, dev = now.shape[0], now.device
    node = pay[:, 0]
    acc = _i32(w.acc.to(torch.int64) + (rand[:, 0] ^ rand[:, 1]))
    idx = acc & (_L - 1)
    flat = torch.arange(_N * _L, dtype=I32, device=dev).reshape(1, _N, _L)
    mask = flat == (node * _L + idx)[:, None, None]
    ring = torch.where(mask, _i32(rand[:, 2])[:, None, None], w.ring)

    delay = bounded(rand[:, 3], _DELAY_LO, _DELAY_HI)
    next_node = bounded(rand[:, 4], 0, _N).to(I32)

    times = now[:, None].expand(s, _MAX_EMITS).clone()
    times[:, 0] = now + delay
    pays = torch.zeros((s, _MAX_EMITS, _P), dtype=I32, device=dev)
    pays[:, 0, 0] = next_node
    pays[:, 0, 1] = _i32(rand[:, 5])
    enables = (torch.arange(_MAX_EMITS, device=dev) < 1).expand(s, -1)
    return _ProbeW(ring=ring, acc=acc, nsent=w.nsent + 1), Emits(
        times=times,
        kinds=torch.zeros((s, _MAX_EMITS), dtype=I32, device=dev),
        pays=pays,
        enables=enables,
    )


def probe_workload() -> Workload:
    return Workload(
        init=_probe_init,
        handle=_probe_handle,
        num_rand=_NUM_RAND,
        payload_slots=_P,
        max_emits=_MAX_EMITS,
    )


def probe_config(max_steps: int) -> EngineConfig:
    """A horizon far beyond ``max_steps`` x 20 ms, so no seed finishes:
    every seed runs exactly ``max_steps`` events."""
    return EngineConfig(queue_capacity=_Q, time_limit_ns=1 << 62, max_steps=max_steps)


def run_megasweep_ref(
    state: EngineState, steps: int, time_limit: int = 1 << 62
) -> EngineState:
    """The plain version: ``steps`` calls of ``core.step_batch`` on the
    probe workload, on the state's own device. (On a CUDA state the pop
    decision inside each step is the pop-min kernel, itself held to its
    plain version; everything else is torch ops.)"""
    wl = probe_workload()
    cfg = EngineConfig(
        queue_capacity=state.queue.time.shape[1], time_limit_ns=time_limit, max_steps=steps
    )
    for _ in range(steps):
        state = step_batch(wl, cfg, state, device=state.now_ns.device)
    return state


class MegasweepCounts(NamedTuple):
    """What a megasweep's events needed, counted on the plain path."""

    events: int  # (seed, step) pairs where the seed was live
    taken: int  # events that ran the handler
    tied: int  # events whose minimum deadline two or more slots held
    tied_slots: int  # the slots at those tied minima
    live_visits: int  # live slots at each event's pop, summed


def run_megasweep_counted(
    state: EngineState, steps: int, time_limit: int = 1 << 62
) -> Tuple[EngineState, MegasweepCounts]:
    """``run_megasweep_ref``'s loop, also returning what its events
    needed: before each step, the live seeds' queue occupancy and whether
    their minimum deadline is tied; after it, which seeds advanced."""
    wl = probe_workload()
    cfg = EngineConfig(
        queue_capacity=state.queue.time.shape[1], time_limit_ns=time_limit, max_steps=steps
    )
    counts = torch.zeros(5, dtype=torch.int64, device=state.now_ns.device)
    for _ in range(steps):
        t = state.queue.time
        live = ~state.done
        tmin = t.min(dim=1).values
        at_min = (t == tmin[:, None]).sum(dim=1)
        tied = live & (tmin != INVALID_TIME) & (at_min > 1)
        ctr = state.ctr
        state = step_batch(wl, cfg, state, device=state.now_ns.device)
        counts += torch.stack([
            live.sum(), (state.ctr != ctr).sum(), tied.sum(), (at_min * tied).sum(),
            ((t != INVALID_TIME).sum(dim=1) * live).sum(),
        ])
    return state, MegasweepCounts(*counts.tolist())


def _check(state: EngineState, tile: int) -> None:
    """What the reference's ``run_megasweep`` refuses."""
    s = state.seed.shape[0]
    if tile < 1 or s % tile:
        raise ValueError(f"batch {s} must be a multiple of tile {tile}")
    if state.cover.shape[1]:
        raise ValueError(
            "run_megasweep does not fold coverage bits (the probe workload "
            "defines none); a cover-enabled workload would silently report "
            "all-zero coverage"
        )
    if state.hist_rec.shape[1]:
        raise ValueError(
            "run_megasweep does not append op-history records (the probe "
            "workload records none); a record-enabled workload would "
            "silently report an empty history"
        )


def run_megasweep(
    state: EngineState, steps: int, time_limit: int = 1 << 62, tile: int = 256
) -> EngineState:
    """Advance a batched probe-workload state ``steps`` events per seed;
    returns the same ``EngineState`` structure and dtypes as the engine's
    step, equal leaf for leaf.

    ``tile`` keeps the reference's contract only: ``S`` must be a
    multiple of it. (The reference makes one ``pallas_call`` per tile to
    fit the TPU's VMEM; on the card every seed is one thread, its queue in
    its block's shared memory whatever the launch size, so one launch of
    ``S / 64`` blocks runs the whole batch, and ``tile`` does not change
    it.) On a CUDA state the kernel runs the events; on a
    CPU state the plain version runs. Any other device raises."""
    _check(state, tile)
    dev = state.now_ns.device
    if dev.type == "cpu":
        return run_megasweep_ref(state, steps, time_limit)
    if dev.type != "cuda":
        raise ValueError(f"run_megasweep: unsupported device {dev}")
    planes = cuda_megasweep.planes(state)
    cuda_megasweep.launch(planes, steps, time_limit)
    run_megasweep.launches += 1
    return cuda_megasweep.to_state(state, planes)


run_megasweep.launches = 0
