"""Declarative fault campaigns, batched (counterpart of
``madsim_tpu/engine/faults.py``, the part the main path runs).

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
- ``FixedFaults``: a literal, seedless schedule.
- Spec as data: a ``FaultEnvelope`` is a campaign's static shape (the
  padded window capacity per family); ``spec_to_params`` compiles one
  concrete spec to ``FaultParams`` (host numpy, validated eagerly),
  ``tile_params``/``stack_params``/``grid_params`` lay them out per lane,
  and ``schedule_events_padded`` derives the envelope-shaped schedule
  whose enabled rows equal ``schedule_events`` of the spec bit for bit.
  A model then carries the candidate's runtime scalars (``FaultRt``) per
  lane and reads them through ``runtime_spec``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import net as enet
from . import tree
from .core import Emits, params_to_device
from .ops import get1, set1, wide
from .rng import M32, bits, bounded, fold_in, prob_to_q32, threefry2x32

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

ACTION_NAMES = (
    "crash", "restart", "partition", "heal", "spike_on", "spike_off",
    "loss_on", "loss_off", "pause", "resume", "part_in", "heal_in",
    "part_out", "heal_out", "fsync_stall", "fsync_ok", "power_fail",
    "skew_on", "skew_off",
)
ACTION_CODES = {name: i for i, name in enumerate(ACTION_NAMES)}

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


class FixedFaults(NamedTuple):
    """A literal fault schedule: ``events`` are ``(time_ns, action_name,
    victim)`` triples, the same for every seed (no draws). The override
    fields carry what burst "on" transitions and skew windows need."""

    events: Tuple[Tuple[int, str, int], ...] = ()
    spike_lat_lo_ns: int = 1_000_000_000
    spike_lat_hi_ns: int = 5_000_000_000
    burst_loss_q32: int = prob_to_q32(0.5)
    skew_num: int = 3
    skew_den: int = 2


# -- spec as data: the campaign envelope ------------------------------------

# fixed family order, the draw order of _categories
FAMILIES = (
    "crashes", "partitions", "spikes", "losses", "pauses",
    "aparts", "fsync_stalls", "power_fails", "skews",
)
N_FAMILIES = len(FAMILIES)
_F_APART = FAMILIES.index("aparts")
_F_FSYNC = FAMILIES.index("fsync_stalls")
_F_SKEW = FAMILIES.index("skews")

# (window, dur_lo, dur_hi, group) spec fields per family; group None =
# the network-wide burst families (victim range [0, 1))
_FAMILY_FIELDS = (
    ("crash_window_ns", "restart_lo_ns", "restart_hi_ns", "crash_group"),
    ("part_window_ns", "part_lo_ns", "part_hi_ns", "part_group"),
    ("spike_window_ns", "spike_dur_lo_ns", "spike_dur_hi_ns", None),
    ("loss_window_ns", "loss_dur_lo_ns", "loss_dur_hi_ns", None),
    ("pause_window_ns", "pause_lo_ns", "pause_hi_ns", "pause_group"),
    ("apart_window_ns", "apart_lo_ns", "apart_hi_ns", "apart_group"),
    ("fsync_window_ns", "fsync_lo_ns", "fsync_hi_ns", "fsync_group"),
    ("power_window_ns", "power_lo_ns", "power_hi_ns", "power_group"),
    ("skew_window_ns", "skew_lo_ns", "skew_hi_ns", "skew_group"),
)
# (on, off) action codes per family; an apart window's pair is (in, out)
# resolved per window from the victim draw's direction bit
_FAMILY_ACTIONS = (
    (F_CRASH, F_RESTART),
    (F_PART, F_HEAL),
    (F_SPIKE_ON, F_SPIKE_OFF),
    (F_LOSS_ON, F_LOSS_OFF),
    (F_PAUSE, F_RESUME),
    ((F_PART_IN, F_PART_OUT), (F_HEAL_IN, F_HEAL_OUT)),
    (F_FSYNC_STALL, F_FSYNC_OK),
    (F_POWER_FAIL, F_RESTART),
    (F_SKEW_ON, F_SKEW_OFF),
)


class FaultEnvelope(NamedTuple):
    """The static shape of a fault campaign: ``maxima[f]`` window pairs of
    family ``f`` (``FAMILIES`` order) and ``fixed`` literal rows. Every
    concrete spec whose counts fit compiles to ``FaultParams`` and runs
    through the same shapes."""

    maxima: Tuple[int, ...] = (0,) * N_FAMILIES
    fixed: int = 0


class FaultRt(NamedTuple):
    """One candidate's runtime override scalars (per lane on the envelope
    path) — the ``FaultSpec`` fields ``on_event``/``skewed_delay`` read."""

    spike_lat_lo_ns: object  # int64
    spike_lat_hi_ns: object  # int64
    burst_loss_q32: object  # uint32
    skew_num: object  # int64
    skew_den: object  # int64


class FaultParams(NamedTuple):
    """One concrete fault campaign as data. Per-family arrays are in
    ``FAMILIES`` order; rows beyond ``counts[f]`` are disabled. ``fx_*``
    hold a ``FixedFaults`` schedule padded to the envelope's ``fixed``.
    Host numpy from ``spec_to_params`` (leading lane axis after
    ``tile_params``/``stack_params``/``grid_params``); the engine moves
    them to the sweep's device."""

    counts: object  # int32[N_FAMILIES]
    windows: object  # int64[N_FAMILIES]
    dur_lo: object  # int64[N_FAMILIES]
    dur_hi: object  # int64[N_FAMILIES]
    vic_lo: object  # int32[N_FAMILIES]
    vic_hi: object  # int32[N_FAMILIES] (exclusive)
    fx_times: object  # int64[fixed]
    fx_actions: object  # int32[fixed]
    fx_victims: object  # int32[fixed]
    fx_count: object  # int32 ()
    rt: FaultRt


def campaign_envelope(*specs, mutation_cap: int = 0, fixed: int = 0) -> FaultEnvelope:
    """The envelope covering every given spec: per family the largest
    count over the specs and ``mutation_cap``; ``fixed`` the longest
    literal schedule."""
    maxima = [mutation_cap] * N_FAMILIES
    for spec in specs:
        if isinstance(spec, FixedFaults):
            fixed = max(fixed, len(spec.events))
            continue
        for i, f in enumerate(FAMILIES):
            maxima[i] = max(maxima[i], getattr(spec, f))
    return FaultEnvelope(maxima=tuple(maxima), fixed=fixed)


def _check_fixed_event(event, num_nodes: int) -> None:
    t, action, vic = event
    if action not in ACTION_CODES:
        raise ValueError(f"unknown fault action {action!r}")
    if not 0 <= vic < num_nodes:
        raise ValueError(
            f"victim {vic} outside [0, {num_nodes}) in fixed schedule "
            f"event {(t, action, vic)!r}"
        )


def spec_to_params(spec, envelope: FaultEnvelope, num_nodes: int) -> FaultParams:
    """Compile one concrete ``FaultSpec`` or ``FixedFaults`` to the
    envelope's layout, in host numpy, validating eagerly (group
    resolution, capacity fit)."""
    counts = np.zeros((N_FAMILIES,), np.int32)
    windows = np.ones((N_FAMILIES,), np.int64)
    dur_lo = np.zeros((N_FAMILIES,), np.int64)
    dur_hi = np.ones((N_FAMILIES,), np.int64)
    vic_lo = np.zeros((N_FAMILIES,), np.int32)
    vic_hi = np.ones((N_FAMILIES,), np.int32)
    fx_times = np.zeros((envelope.fixed,), np.int64)
    fx_actions = np.zeros((envelope.fixed,), np.int32)
    fx_victims = np.zeros((envelope.fixed,), np.int32)
    fx_count = np.int32(0)
    if isinstance(spec, FixedFaults):
        e = len(spec.events)
        if e > envelope.fixed:
            raise ValueError(
                f"FixedFaults schedule of {e} events exceeds the envelope's "
                f"fixed capacity {envelope.fixed}"
            )
        for i, event in enumerate(spec.events):
            _check_fixed_event(event, num_nodes)
            fx_times[i] = event[0]
            fx_actions[i] = ACTION_CODES[event[1]]
            fx_victims[i] = event[2]
        fx_count = np.int32(e)
    else:
        for i, (fam, fields) in enumerate(zip(FAMILIES, _FAMILY_FIELDS)):
            count = getattr(spec, fam)
            if count > envelope.maxima[i]:
                raise ValueError(
                    f"spec draws {count} {fam} windows but the envelope caps "
                    f"the family at {envelope.maxima[i]}"
                )
            win_f, lo_f, hi_f, group_f = fields
            counts[i] = count
            windows[i] = getattr(spec, win_f)
            dur_lo[i] = getattr(spec, lo_f)
            dur_hi[i] = getattr(spec, hi_f)
            if group_f is None:
                vic_lo[i], vic_hi[i] = 0, 1
            else:
                # validated even for count-0 families, like _categories
                vic_lo[i], vic_hi[i] = _resolve_group(
                    getattr(spec, group_f), num_nodes, fam
                )
    return FaultParams(
        counts=counts,
        windows=windows,
        dur_lo=dur_lo,
        dur_hi=dur_hi,
        vic_lo=vic_lo,
        vic_hi=vic_hi,
        fx_times=fx_times,
        fx_actions=fx_actions,
        fx_victims=fx_victims,
        fx_count=fx_count,
        rt=FaultRt(
            spike_lat_lo_ns=np.int64(spec.spike_lat_lo_ns),
            spike_lat_hi_ns=np.int64(spec.spike_lat_hi_ns),
            burst_loss_q32=np.uint32(spec.burst_loss_q32),
            skew_num=np.int64(spec.skew_num),
            skew_den=np.int64(spec.skew_den),
        ),
    )


def tile_params(params: FaultParams, n: int) -> FaultParams:
    """One candidate's params broadcast to ``n`` lanes."""
    return tree.map(lambda a: np.broadcast_to(np.asarray(a), (n,) + np.shape(a)), params)


def stack_params(params_list) -> FaultParams:
    """K candidates' params stacked on a leading axis K."""
    return tree.map(lambda *ls: np.stack(ls), *params_list)


def grid_params(params_list, lanes: int) -> FaultParams:
    """The (candidate x seed) grid: candidate k owns lanes
    ``[k * lanes, (k + 1) * lanes)`` of one flat ``K * lanes`` batch."""
    return tree.map(
        lambda *ls: np.concatenate(
            [np.broadcast_to(np.asarray(a), (lanes,) + np.shape(a)) for a in ls]
        ),
        *params_list,
    )


def runtime_spec(spec, frt):
    """The spec view the interpreter reads values from: the static spec,
    or this lane's ``FaultRt`` on the envelope path."""
    return frt if isinstance(spec, FaultEnvelope) else spec


def make_rt(spec, params: Optional[FaultParams] = None):
    """The workload-state ``frt`` slot: the per-lane ``FaultRt`` on the
    envelope path, a leafless ``()`` otherwise."""
    if isinstance(spec, FaultEnvelope):
        if params is None:
            raise ValueError(
                "workload config carries a FaultEnvelope; the sweep needs "
                "per-lane FaultParams (pass params= through run_sweep — "
                "build them with spec_to_params + tile_params)"
            )
        return params.rt
    return ()


def bits_at(key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Draw ``idx`` of ``bits(key, n)`` for any ``n > idx``: per key
    (int64 words ``[S, 2]``) the words at explicit 32-bit counters
    ``idx [S, ...]`` (int64), as int64 words."""
    shape = (key.shape[0],) + (1,) * (idx.ndim - 1)
    k0 = key[:, 0].reshape(shape)
    k1 = key[:, 1].reshape(shape)
    i = idx.to(torch.int64) & M32
    o0, o1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
    return o0 ^ o1


def schedule_events_padded(envelope: FaultEnvelope, params: FaultParams, num_nodes: int,
                           key: torch.Tensor):
    """The envelope-shaped schedule of per-lane ``params`` (a leading lane
    axis on every leaf) and keys ``[S, 2]``: ``(times int64[S, E],
    actions int32[S, E], victims int32[S, E], enables bool[S, E])`` with
    ``E = num_events(envelope)``; per lane the enabled rows, in order,
    equal ``schedule_events`` of the candidate spec."""
    s, dev = key.shape[0], key.device
    params = params_to_device(params, dev)
    pmax = sum(envelope.maxima)
    cols = ([], [], [], [])
    if pmax:
        fam = torch.from_numpy(np.repeat(np.arange(N_FAMILIES), envelope.maxima)).to(dev)
        row = torch.from_numpy(
            np.concatenate([np.arange(m) for m in envelope.maxima]).astype(np.int32)
        ).to(dev)
        counts = params.counts.to(torch.int32)
        base = torch.cat(
            [torch.zeros((s, 1), dtype=torch.int32, device=dev),
             torch.cumsum(counts, dim=1, dtype=torch.int32)], dim=1,
        )
        pair = base[:, fam] + row
        active = row < counts[:, fam]
        fkey = fold_in(key.to(torch.int64), FAULT_STREAM)
        # inactive rows hash counter 0; their draws are never used
        i3 = torch.where(active, 3 * pair, 0).to(torch.int64)
        r_start = bits_at(fkey, i3)
        r_dur = bits_at(fkey, i3 + 1)
        r_vic = bits_at(fkey, i3 + 2)

        t0 = bounded(r_start, 0, params.windows[:, fam])
        dur = bounded(r_dur, params.dur_lo[:, fam], params.dur_hi[:, fam])
        vlo = params.vic_lo[:, fam]
        vhi = params.vic_hi[:, fam]
        directional = fam == _F_APART
        d = bounded(r_vic, 0, 2 * (vhi - vlo))
        vic = torch.where(
            directional, vlo + (d >> 1), bounded(r_vic, vlo, vhi)
        ).to(torch.int32)
        out_dir = directional & ((d & 1) == 1)
        # per-family codes; an apart window's inbound pair unless its
        # direction bit says outbound
        on_code, off_code = (
            torch.tensor([a[0] if isinstance(a, tuple) else a for a in codes],
                         dtype=torch.int32, device=dev)[fam]
            for codes in zip(*_FAMILY_ACTIONS)
        )
        on = torch.where(out_dir, F_PART_OUT, on_code).to(torch.int32)
        off = torch.where(out_dir, F_HEAL_OUT, off_code).to(torch.int32)
        # (on, off) interleaved per pair: the static path's row order
        cols[0].append(torch.stack([t0, t0 + dur], dim=2).reshape(s, 2 * pmax))
        cols[1].append(torch.stack([on, off], dim=2).reshape(s, 2 * pmax))
        cols[2].append(torch.stack([vic, vic], dim=2).reshape(s, 2 * pmax))
        cols[3].append(active.repeat_interleave(2, dim=1))
    if envelope.fixed:
        idx = torch.arange(envelope.fixed, dtype=torch.int32, device=dev)
        cols[0].append(params.fx_times.to(torch.int64))
        cols[1].append(params.fx_actions.to(torch.int32))
        cols[2].append(params.fx_victims.to(torch.int32))
        cols[3].append(idx[None, :] < params.fx_count.to(torch.int32)[:, None])
    empty = (torch.int64, torch.int32, torch.int32, torch.bool)
    return tuple(
        torch.cat(c, dim=1) if c else torch.zeros((s, 0), dtype=dt, device=dev)
        for c, dt in zip(cols, empty)
    )


def num_events(spec) -> int:
    """Static event count of the compiled campaign: an on/off pair per
    window of a ``FaultSpec``, the literal length of ``FixedFaults``, the
    padded capacity of a ``FaultEnvelope``."""
    if isinstance(spec, FixedFaults):
        return len(spec.events)
    if isinstance(spec, FaultEnvelope):
        return 2 * sum(spec.maxima) + spec.fixed
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
    int32[S, E])`` in pair order (not time-sorted). A ``FixedFaults``
    schedule is the same literal events for every seed."""
    s = key.shape[0]
    if isinstance(spec, FixedFaults):
        for event in spec.events:
            _check_fixed_event(event, num_nodes)
        e = len(spec.events)

        def lit(vals, dtype):
            return torch.tensor(vals, dtype=dtype, device=key.device).reshape(1, e).expand(s, e)

        return (
            lit([t for t, _, _ in spec.events], torch.int64),
            lit([ACTION_CODES[a] for _, a, _ in spec.events], torch.int32),
            lit([v for _, _, v in spec.events], torch.int32),
        )
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
    params: Optional[FaultParams] = None,
) -> Emits:
    """The campaign as a fault event stream ``Emits [S, E]`` with payload
    ``(action, victim, t_lo, t_hi)``. A ``FaultEnvelope`` compiles the
    per-lane candidates in ``params`` (tensors on the keys' device)
    through the padded derivation, with the enabled rows moved to the
    front in order: ``push_many`` gives emit ``e`` the ``e``-th free slot
    and ties break by slot, so only a hole-free stream takes the slots
    the static path's stream takes."""
    if payload_slots < 4:
        raise ValueError(
            f"fault events need 4 payload slots (action, victim, t_lo, "
            f"t_hi); the workload has {payload_slots}"
        )
    if isinstance(spec, FaultEnvelope):
        if params is None:
            raise ValueError(
                "compiling a FaultEnvelope needs the candidate's FaultParams "
                "(spec_to_params)"
            )
        times, actions, victims, enables = schedule_events_padded(
            spec, params, num_nodes, key
        )
        order = torch.argsort((~enables).to(torch.int32), dim=1, stable=True)
        times = torch.gather(times, 1, order)
        actions = torch.gather(actions, 1, order)
        victims = torch.gather(victims, 1, order)
        enables = torch.gather(enables, 1, order)
    else:
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


def decode_time(t_lo, t_hi):
    """The scheduled deadline from a fault event payload."""
    return (torch.as_tensor(t_hi).to(torch.int64) << 31) | torch.as_tensor(t_lo).to(torch.int64)


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
    """Whether the static spec can ever open a clock-skew window (an
    envelope decides once per campaign)."""
    if isinstance(spec, FixedFaults):
        return any(a in ("skew_on", "skew_off") for _, a, _ in spec.events)
    if isinstance(spec, FaultEnvelope):
        return spec.maxima[_F_SKEW] > 0 or spec.fixed > 0
    return spec.skews > 0


def can_stall(spec) -> bool:
    """Whether the static spec can ever open a slow-disk window (an
    envelope decides once per campaign)."""
    if isinstance(spec, FixedFaults):
        return any(a == "fsync_stall" for _, a, _ in spec.events)
    if isinstance(spec, FaultEnvelope):
        return spec.maxima[_F_FSYNC] > 0 or spec.fixed > 0
    return spec.fsync_stalls > 0


def skewed_delay(spec, f: FaultState, node, delay_ns, rt=None):
    """A timer interval as the (possibly skewed) node's clock measures it:
    stretched by ``skew_num / skew_den`` while ``node`` is inside a skew
    window; the identity for skew-free specs."""
    d = delay_ns
    if not can_skew(spec):
        return d
    v = spec if rt is None else rt
    slow = get1(f.skew_cnt, node) > 0
    return torch.where(slow, d * v.skew_num // v.skew_den, d)


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
