# The benchmark's plain reference: a frozen copy of madsim_tpu_torch/engine/faults.py, run on the CPU.
# A change to the program's semantics reaches it only through a change to the benchmark.
"""Declarative fault campaigns, batched (counterpart of
``madsim_tpu/engine/faults.py``, the part the benchmark's configurations
run: a static ``FaultSpec``).

- ``FaultSpec``: the reference's declarative campaign, field for field.
- ``schedule_events(spec, num_nodes, key)``: the schedule derivation —
  per window pair ``i`` (in category order) the draws ``3i`` (start),
  ``3i+1`` (duration) and ``3i+2`` (victim) of ``bits(fold_in(key,
  FAULT_STREAM))`` — evaluated for every seed of the batch at once.
- ``compile_device``: the schedule packed as a fault event stream with
  payload ``(action, victim, t_lo, t_hi)``, ``t = t_hi << 31 | t_lo``.
- ``FaultState`` + ``on_event``: the shared in-loop interpreter (liveness
  and pause masks, per-direction partition refcounts, slow-disk and
  clock-skew refcounts, refcounted latency and loss bursts).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import net as enet
from .core import Emits
from .ops import get1, set1, wide
from .rng import bits, bounded, fold_in, prob_to_q32

# fault action codes (payload slot 0 of a fault event)
F_CRASH = 0
F_RESTART = 1
F_PART = 2
F_HEAL = 3
F_SPIKE_ON = 4
F_SPIKE_OFF = 5
F_LOSS_ON = 6
F_LOSS_OFF = 7
F_PAUSE = 8
F_RESUME = 9
F_PART_IN = 10
F_HEAL_IN = 11
F_PART_OUT = 12
F_HEAL_OUT = 13
F_FSYNC_STALL = 14
F_FSYNC_OK = 15
F_POWER_FAIL = 16
F_SKEW_ON = 17
F_SKEW_OFF = 18


# fold_in namespace of the fault-schedule draws (disjoint from the
# models' init namespace 0x7FFF_FFFF and from per-event counters)
FAULT_STREAM = 0x5EED_FA17 & 0x7FFF_FFFF

Group = Tuple[int, int]  # victim range [lo, hi); hi = -1 means num_nodes


class FaultSpec(NamedTuple):
    """A declarative fault campaign (the reference's fields, defaults and
    order). Every category is ``count`` (start, end) windows with starts
    uniform in ``[0, window_ns)`` and durations uniform in
    ``[dur_lo_ns, dur_hi_ns)``; victims come from the category's node
    group ``[lo, hi)``."""

    crashes: int = 0
    crash_window_ns: int = 5_000_000_000
    restart_lo_ns: int = 100_000_000
    restart_hi_ns: int = 1_000_000_000
    crash_group: Group = (0, -1)
    partitions: int = 0
    part_window_ns: int = 3_000_000_000
    part_lo_ns: int = 500_000_000
    part_hi_ns: int = 2_000_000_000
    part_group: Group = (0, -1)
    spikes: int = 0
    spike_window_ns: int = 3_000_000_000
    spike_dur_lo_ns: int = 200_000_000
    spike_dur_hi_ns: int = 1_000_000_000
    spike_lat_lo_ns: int = 1_000_000_000
    spike_lat_hi_ns: int = 5_000_000_000
    losses: int = 0
    loss_window_ns: int = 3_000_000_000
    loss_dur_lo_ns: int = 200_000_000
    loss_dur_hi_ns: int = 1_000_000_000
    burst_loss_q32: int = prob_to_q32(0.5)
    pauses: int = 0
    pause_window_ns: int = 3_000_000_000
    pause_lo_ns: int = 100_000_000
    pause_hi_ns: int = 1_000_000_000
    pause_group: Group = (0, -1)
    aparts: int = 0
    apart_window_ns: int = 3_000_000_000
    apart_lo_ns: int = 500_000_000
    apart_hi_ns: int = 2_000_000_000
    apart_group: Group = (0, -1)
    fsync_stalls: int = 0
    fsync_window_ns: int = 3_000_000_000
    fsync_lo_ns: int = 500_000_000
    fsync_hi_ns: int = 2_000_000_000
    fsync_group: Group = (0, -1)
    power_fails: int = 0
    power_window_ns: int = 5_000_000_000
    power_lo_ns: int = 100_000_000
    power_hi_ns: int = 1_000_000_000
    power_group: Group = (0, -1)
    skews: int = 0
    skew_window_ns: int = 3_000_000_000
    skew_lo_ns: int = 500_000_000
    skew_hi_ns: int = 2_000_000_000
    skew_group: Group = (0, -1)
    skew_num: int = 3
    skew_den: int = 2


def num_events(spec) -> int:
    """Static event count of the compiled campaign: an on/off pair per
    window."""
    return 2 * (
        spec.crashes + spec.partitions + spec.spikes + spec.losses
        + spec.pauses + spec.aparts + spec.fsync_stalls + spec.power_fails
        + spec.skews
    )


def _resolve_group(group: Group, num_nodes: int, what: str) -> Tuple[int, int]:
    lo, hi = group
    if hi < 0:
        hi = num_nodes
    if not 0 <= lo < hi <= num_nodes:
        raise ValueError(
            f"{what} group {group} does not resolve to a non-empty node "
            f"range within [0, {num_nodes})"
        )
    return lo, hi


def _categories(spec: FaultSpec, num_nodes: int):
    """(count, on_action, off_action, window, dur_lo, dur_hi, vic_lo,
    vic_hi) per category, in the fixed draw order; the asymmetric
    category's actions are (in, out) pairs."""
    return (
        (spec.crashes, F_CRASH, F_RESTART, spec.crash_window_ns,
         spec.restart_lo_ns, spec.restart_hi_ns,
         *_resolve_group(spec.crash_group, num_nodes, "crash")),
        (spec.partitions, F_PART, F_HEAL, spec.part_window_ns,
         spec.part_lo_ns, spec.part_hi_ns,
         *_resolve_group(spec.part_group, num_nodes, "partition")),
        (spec.spikes, F_SPIKE_ON, F_SPIKE_OFF, spec.spike_window_ns,
         spec.spike_dur_lo_ns, spec.spike_dur_hi_ns, 0, 1),
        (spec.losses, F_LOSS_ON, F_LOSS_OFF, spec.loss_window_ns,
         spec.loss_dur_lo_ns, spec.loss_dur_hi_ns, 0, 1),
        (spec.pauses, F_PAUSE, F_RESUME, spec.pause_window_ns,
         spec.pause_lo_ns, spec.pause_hi_ns,
         *_resolve_group(spec.pause_group, num_nodes, "pause")),
        (spec.aparts, (F_PART_IN, F_PART_OUT), (F_HEAL_IN, F_HEAL_OUT),
         spec.apart_window_ns, spec.apart_lo_ns, spec.apart_hi_ns,
         *_resolve_group(spec.apart_group, num_nodes, "apart")),
        (spec.fsync_stalls, F_FSYNC_STALL, F_FSYNC_OK,
         spec.fsync_window_ns, spec.fsync_lo_ns, spec.fsync_hi_ns,
         *_resolve_group(spec.fsync_group, num_nodes, "fsync")),
        (spec.power_fails, F_POWER_FAIL, F_RESTART,
         spec.power_window_ns, spec.power_lo_ns, spec.power_hi_ns,
         *_resolve_group(spec.power_group, num_nodes, "power")),
        (spec.skews, F_SKEW_ON, F_SKEW_OFF, spec.skew_window_ns,
         spec.skew_lo_ns, spec.skew_hi_ns,
         *_resolve_group(spec.skew_group, num_nodes, "skew")),
    )


def schedule_events(spec, num_nodes: int, key: torch.Tensor):
    """The schedule derivation for a batch of keys (int64 words
    ``[S, 2]``): ``(times int64[S, E], actions int32[S, E], victims
    int32[S, E])`` in pair order (not time-sorted)."""
    s = key.shape[0]
    e = num_events(spec)
    if e == 0:
        z = torch.zeros((s, 0), dtype=torch.int64, device=key.device)
        return z, z.to(torch.int32), z.to(torch.int32)
    rand = bits(fold_in(key, FAULT_STREAM), 3 * (e // 2))
    times, actions, victims = [], [], []
    i = 0
    for count, a_on, a_off, window, dlo, dhi, vlo, vhi in _categories(spec, num_nodes):
        for _ in range(count):
            t0 = bounded(rand[:, 3 * i], 0, window)
            dur = bounded(rand[:, 3 * i + 1], dlo, dhi)
            if isinstance(a_on, tuple):
                # directional: the victim draw spans twice the node range
                # and its low bit picks inbound vs outbound
                d = bounded(rand[:, 3 * i + 2], 0, 2 * (vhi - vlo))
                vic = (vlo + (d >> 1)).to(torch.int32)
                out = (d & 1) == 1
                on = torch.where(out, a_on[1], a_on[0]).to(torch.int32)
                off = torch.where(out, a_off[1], a_off[0]).to(torch.int32)
            else:
                vic = bounded(rand[:, 3 * i + 2], vlo, vhi).to(torch.int32)
                on = torch.full((s,), a_on, dtype=torch.int32, device=key.device)
                off = torch.full((s,), a_off, dtype=torch.int32, device=key.device)
            times += [t0, t0 + dur]
            actions += [on, off]
            victims += [vic, vic]
            i += 1
    return (
        torch.stack(times, dim=1),
        torch.stack(actions, dim=1),
        torch.stack(victims, dim=1),
    )


def compile_device(
    spec, num_nodes: int, key: torch.Tensor, fault_kind: int, payload_slots: int,
) -> Emits:
    """The campaign as a fault event stream ``Emits [S, E]`` with payload
    ``(action, victim, t_lo, t_hi)``."""
    if payload_slots < 4:
        raise ValueError(
            f"fault events need 4 payload slots (action, victim, t_lo, "
            f"t_hi); the workload has {payload_slots}"
        )
    times, actions, victims = schedule_events(spec, num_nodes, key)
    enables = torch.ones(times.shape, dtype=torch.bool, device=key.device)
    s, e = times.shape
    pays = torch.zeros((s, e, payload_slots), dtype=torch.int32, device=key.device)
    if e:
        pays[:, :, 0] = actions
        pays[:, :, 1] = victims
        pays[:, :, 2] = (times & 0x7FFF_FFFF).to(torch.int32)
        pays[:, :, 3] = (times >> 31).to(torch.int32)
    return Emits(
        times=times,
        kinds=torch.full((s, e), fault_kind, dtype=torch.int32, device=key.device),
        pays=pays,
        enables=enables,
    )


class NetBase(NamedTuple):
    """The model's base network parameters (static python ints) — what a
    burst's "off" transition restores."""

    lat_lo_ns: int
    lat_hi_ns: int
    loss_q32: int


class FaultState(NamedTuple):
    """Per-seed interpreter state, batched (partition refcounts are per
    direction; a direction is clogged iff its count is > 0)."""

    alive: torch.Tensor  # bool[S, N]
    paused: torch.Tensor  # bool[S, N]
    part_in_cnt: torch.Tensor  # int32[S, N]
    part_out_cnt: torch.Tensor  # int32[S, N]
    fsync_cnt: torch.Tensor  # int32[S, N]
    skew_cnt: torch.Tensor  # int32[S, N]
    spike_cnt: torch.Tensor  # int32[S]
    loss_cnt: torch.Tensor  # int32[S]


class FaultEdges(NamedTuple):
    """The transitions one fault event actually caused (per seed)."""

    crashed: torch.Tensor  # a live victim died (crash or power_fail)
    restarted: torch.Tensor  # a dead victim revived
    paused: torch.Tensor  # a live, running victim paused
    resumed: torch.Tensor  # a live, paused victim resumed


def init_state(num_seeds: int, num_nodes: int, device=None) -> FaultState:
    def z(shape, dtype):
        return torch.zeros((num_seeds,) + shape, dtype=dtype, device=device)

    return FaultState(
        alive=torch.ones((num_seeds, num_nodes), dtype=torch.bool, device=device),
        paused=z((num_nodes,), torch.bool),
        part_in_cnt=z((num_nodes,), torch.int32),
        part_out_cnt=z((num_nodes,), torch.int32),
        fsync_cnt=z((num_nodes,), torch.int32),
        skew_cnt=z((num_nodes,), torch.int32),
        spike_cnt=z((), torch.int32),
        loss_cnt=z((), torch.int32),
    )


def up(f: FaultState) -> torch.Tensor:
    """bool[S, N]: node is processing events (alive and not paused)."""
    return f.alive & ~f.paused


def stalled(f: FaultState) -> torch.Tensor:
    """bool[S, N]: node's disk is inside a slow-disk window."""
    return f.fsync_cnt > 0


def can_skew(spec) -> bool:
    """Whether the spec can ever open a clock-skew window."""
    return spec.skews > 0


def can_stall(spec) -> bool:
    """Whether the spec can ever open a slow-disk window."""
    return spec.fsync_stalls > 0


def skewed_delay(spec, f: FaultState, node, delay_ns):
    """A timer interval as the (possibly skewed) node's clock measures it:
    stretched by ``skew_num / skew_den`` while ``node`` is inside a skew
    window; the identity for skew-free specs."""
    d = delay_ns
    if not can_skew(spec):
        return d
    slow = get1(f.skew_cnt, node) > 0
    return torch.where(slow, d * spec.skew_num // spec.skew_den, d)


def on_event(spec, base: NetBase, links: enet.LinkState, f: FaultState, action, victim):
    """Apply one fault event per seed; returns ``(links, fstate, edges)``.
    Partition and burst transitions are refcounted: only the 0->1 edge
    applies and only the 1->0 edge restores."""
    is_crash = (action == F_CRASH) | (action == F_POWER_FAIL)
    is_restart = action == F_RESTART
    is_part = action == F_PART
    is_heal = action == F_HEAL
    is_spike_on = action == F_SPIKE_ON
    is_spike_off = action == F_SPIKE_OFF
    is_loss_on = action == F_LOSS_ON
    is_loss_off = action == F_LOSS_OFF
    is_pause = action == F_PAUSE
    is_resume = action == F_RESUME

    was_alive = get1(f.alive, victim)
    was_paused = get1(f.paused, victim)
    edges = FaultEdges(
        crashed=is_crash & was_alive,
        restarted=is_restart & ~was_alive,
        paused=is_pause & was_alive & ~was_paused,
        resumed=is_resume & was_alive & was_paused,
    )
    alive = set1(f.alive, victim, False, is_crash)
    alive = set1(alive, victim, True, is_restart)
    paused = set1(f.paused, victim, False, is_crash)
    paused = set1(paused, victim, True, is_pause & was_alive)
    paused = set1(paused, victim, False, is_resume & was_alive)

    # partitions per direction; the clog matrix is derived from the
    # refcounts so overlapping windows compose exactly
    inc_in = is_part | (action == F_PART_IN)
    dec_in = is_heal | (action == F_HEAL_IN)
    inc_out = is_part | (action == F_PART_OUT)
    dec_out = is_heal | (action == F_HEAL_OUT)
    in_cnt = get1(f.part_in_cnt, victim)
    out_cnt = get1(f.part_out_cnt, victim)
    part_in_cnt = set1(f.part_in_cnt, victim, in_cnt + 1, inc_in)
    part_in_cnt = set1(part_in_cnt, victim, torch.clamp(in_cnt - 1, min=0), dec_in)
    part_out_cnt = set1(f.part_out_cnt, victim, out_cnt + 1, inc_out)
    part_out_cnt = set1(part_out_cnt, victim, torch.clamp(out_cnt - 1, min=0), dec_out)
    touched = inc_in | dec_in | inc_out | dec_out
    derived = (part_out_cnt > 0)[:, :, None] | (part_in_cnt > 0)[:, None, :]
    clog = torch.where(touched[:, None, None], derived, links.clog)

    fs_cnt = get1(f.fsync_cnt, victim)
    fsync_cnt = set1(f.fsync_cnt, victim, fs_cnt + 1, action == F_FSYNC_STALL)
    fsync_cnt = set1(fsync_cnt, victim, torch.clamp(fs_cnt - 1, min=0), action == F_FSYNC_OK)
    sk_cnt = get1(f.skew_cnt, victim)
    skew_cnt = set1(f.skew_cnt, victim, sk_cnt + 1, action == F_SKEW_ON)
    skew_cnt = set1(skew_cnt, victim, torch.clamp(sk_cnt - 1, min=0), action == F_SKEW_OFF)

    # latency-spike bursts override the whole link latency range
    spike_apply = is_spike_on & (f.spike_cnt == 0)
    spike_restore = is_spike_off & (f.spike_cnt == 1)
    lat_lo = torch.where(
        spike_apply, spec.spike_lat_lo_ns,
        torch.where(spike_restore, base.lat_lo_ns, links.lat_lo_ns),
    )
    lat_hi = torch.where(
        spike_apply, spec.spike_lat_hi_ns,
        torch.where(spike_restore, base.lat_hi_ns, links.lat_hi_ns),
    )
    spike_cnt = torch.where(
        is_spike_on, f.spike_cnt + 1,
        torch.where(is_spike_off, torch.clamp(f.spike_cnt - 1, min=0), f.spike_cnt),
    )

    # message-loss bursts override the loss probability
    loss_apply = is_loss_on & (f.loss_cnt == 0)
    loss_restore = is_loss_off & (f.loss_cnt == 1)
    loss_q32 = torch.where(
        loss_apply, wide(spec.burst_loss_q32),
        torch.where(loss_restore, base.loss_q32, links.loss_q32.to(torch.int64)),
    ).to(torch.uint32)
    loss_cnt = torch.where(
        is_loss_on, f.loss_cnt + 1,
        torch.where(is_loss_off, torch.clamp(f.loss_cnt - 1, min=0), f.loss_cnt),
    )

    links = links._replace(clog=clog, lat_lo_ns=lat_lo, lat_hi_ns=lat_hi, loss_q32=loss_q32)
    f2 = FaultState(
        alive=alive,
        paused=paused,
        part_in_cnt=part_in_cnt,
        part_out_cnt=part_out_cnt,
        fsync_cnt=fsync_cnt,
        skew_cnt=skew_cnt,
        spike_cnt=spike_cnt,
        loss_cnt=loss_cnt,
    )
    return links, f2, edges
