"""Shared emit-packing and summary helpers for the batched models
(counterpart of ``madsim_tpu/models/_common.py``).

Every handler emits a fixed shape per seed: ``num_nodes`` broadcast slots
followed by two "extra" slots (timer re-arms, unicast replies).
``make_sweep_summary`` builds a model's ``sweep_summary`` with the
reference's keys, reductions and ``limit=`` semantics.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..engine.core import Emits

# sentinel for an unused extra slot
DISABLED = None

# sweep_summary keys that merge by max, not sum, across chunks
MAX_KEYS = frozenset({"queue_high_water"})

# keys that merge by elementwise bitwise OR (coverage bitmaps)
OR_KEYS = frozenset({"coverage_map"})

# keys that merge by elementwise add (fixed-width count vectors)
VEC_KEYS = frozenset({"event_mix"})


def merge_summaries(totals: dict, summary: dict) -> dict:
    """Fold one chunk's ``sweep_summary`` dict into a running total
    (sums, except ``MAX_KEYS`` by max, ``OR_KEYS``/``VEC_KEYS``
    elementwise, lists concatenated). Mutates and returns ``totals``."""
    for k, v in summary.items():
        if k in MAX_KEYS:
            totals[k] = max(totals.get(k, 0), v)
        elif k in VEC_KEYS:
            old = totals.get(k, [])
            if len(old) < len(v):
                old = old + [0] * (len(v) - len(old))
            totals[k] = [
                a + b for a, b in zip(old, list(v) + [0] * (len(old) - len(v)))
            ]
        elif k in OR_KEYS:
            old = totals.get(k, [])
            if len(old) < len(v):
                old = old + [0] * (len(v) - len(old))
            totals[k] = [a | b for a, b in zip(old, list(v) + [0] * (len(old) - len(v)))]
        elif isinstance(v, list):
            totals[k] = totals.get(k, []) + v
        else:
            totals[k] = totals.get(k, 0) + v
    return totals


def coverage_bit_count(coverage_map) -> int:
    """Population count of a ``coverage_map`` word list (covered bits)."""
    return sum(int(w).bit_count() for w in coverage_map)


def memoized_workload(cfg_cls):
    """Decorator for a model's ``workload(cfg)``: memoize per config, with
    an omitted argument normalised to ``cfg_cls()`` first, so equal
    configs share one Workload object."""
    from functools import lru_cache, wraps

    def deco(build):
        cached = lru_cache(maxsize=None)(build)

        @wraps(build)
        def workload(cfg=None):
            return cached(cfg if cfg is not None else cfg_cls())

        return workload

    return deco


def make_sweep_summary(
    fields: Tuple[Tuple[str, Callable], ...]
) -> Callable[..., dict]:
    """Build ``sweep_summary(final, limit=None) -> dict`` from ``(name,
    lane_fn)`` pairs; each ``lane_fn(final)`` returns a per-lane ``[S]``
    vector and the reduction (sum, or max for ``MAX_KEYS``) is owned here.
    ``limit=k`` reduces only the first ``k`` lanes (masked, so a zeroed
    lane is the identity of every reduction). The scalars, the coverage
    union and the event-mix histogram come back in one device-to-host
    copy."""
    engine_fields = (
        ("overflow_seeds", lambda f: f.overflow),
        ("hist_overflow_seeds", lambda f: f.hist_overflow),
        ("queue_high_water", lambda f: f.qmax),
        ("events_total", lambda f: f.ctr),
        ("sim_ns_total", lambda f: f.now_ns),
    )
    fields = fields + engine_fields
    names = tuple(n for n, _ in fields)
    fns = tuple(f for _, f in fields)

    def sweep_summary(final, limit=None) -> dict:
        s = final.seed.shape[0]
        m = None
        if limit is not None:
            m = torch.arange(s, device=final.seed.device) < int(limit)
        cols = []
        for name, fn in zip(names, fns):
            lanes = fn(final).to(torch.int64)
            if lanes.ndim != 1:
                raise ValueError(
                    f"sweep_summary field {name!r} must return a per-lane "
                    f"vector [S], got shape {tuple(lanes.shape)}"
                )
            if m is not None:
                lanes = torch.where(m, lanes, 0)
            cols.append(lanes.max() if name in MAX_KEYS else lanes.sum())
        # coverage union: OR the per-seed bitmaps down the batch axis
        cover = final.cover.to(torch.int64)
        emix = final.evmix.to(torch.int64)
        if m is not None:
            cover = torch.where(m[:, None], cover, 0)
            emix = torch.where(m[:, None], emix, 0)
        shifts = torch.arange(32, dtype=torch.int64, device=cover.device)
        planes = (cover[:, :, None] >> shifts) & 1  # [S, W, 32]
        union = (planes.amax(dim=0) << shifts).sum(dim=1)
        emix = emix.sum(dim=0)
        vec = torch.cat([torch.stack(cols), union, emix]).cpu().tolist()
        n = len(names)
        out = {"seeds": s if limit is None else int(limit)}
        out.update(zip(names, vec[:n]))
        w = cover.shape[1]
        if w:
            out["coverage_map"] = vec[n : n + w]
        if emix.shape[0]:
            out["event_mix"] = vec[n + w :]
        return out

    sweep_summary.supports_limit = True
    return sweep_summary


ExtraSlot = Optional[Tuple]  # (time, kind, pay, enable) or DISABLED


def _col(v, s: int, dtype, device) -> torch.Tensor:
    """A per-seed ``[S]`` column from a tensor or a python scalar (filled
    on the device, never copied from the host)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype).expand(s)
    return torch.full((s,), v, dtype=dtype, device=device)


def pay(*vals, slots: int) -> torch.Tensor:
    """Pack per-seed values (``[S]`` tensors or python ints, at least one
    tensor) into an int32 ``[S, slots]`` payload."""
    ref = next(v for v in vals if isinstance(v, torch.Tensor))
    s, dev = ref.shape[0], ref.device
    cols = [_col(v, s, torch.int32, dev) for v in vals]
    cols += [torch.zeros((s,), dtype=torch.int32, device=dev)] * (slots - len(vals))
    return torch.stack(cols, dim=1)


def no_bcast(num_seeds: int, num_nodes: int, payload_slots: int, msg_kind: int, device):
    """An all-disabled broadcast block (still shaped ``[S, num_nodes]``)."""
    return (
        torch.zeros((num_seeds, num_nodes), dtype=torch.int64, device=device),
        torch.full((num_seeds, num_nodes), msg_kind, dtype=torch.int32, device=device),
        torch.zeros((num_seeds, num_nodes, payload_slots), dtype=torch.int32, device=device),
        torch.zeros((num_seeds, num_nodes), dtype=torch.bool, device=device),
    )


def pack_extras(payload_slots: int, num_seeds: int, device, *extras: ExtraSlot) -> Emits:
    """Pack standalone slots into ``Emits [S, len(extras)]``; each slot is
    ``(time, kind, pay, enable)`` (per-seed values or python scalars,
    ``pay`` ``[S, P]``) or ``DISABLED``."""
    s = num_seeds
    ets, eks, eps, eos = [], [], [], []
    for extra in extras:
        if extra is None:
            ets.append(torch.zeros((s,), dtype=torch.int64, device=device))
            eks.append(torch.zeros((s,), dtype=torch.int32, device=device))
            eps.append(torch.zeros((s, payload_slots), dtype=torch.int32, device=device))
            eos.append(torch.zeros((s,), dtype=torch.bool, device=device))
        else:
            et, ek, ep, eo = extra
            ets.append(_col(et, s, torch.int64, device))
            eks.append(_col(ek, s, torch.int32, device))
            eps.append(ep)
            eos.append(_col(eo, s, torch.bool, device))
    return Emits(
        times=torch.stack(ets, dim=1),
        kinds=torch.stack(eks, dim=1),
        pays=torch.stack(eps, dim=1),
        enables=torch.stack(eos, dim=1),
    )


def pack_emits(payload_slots: int, bcast, *extras: ExtraSlot) -> Emits:
    """Pack ``num_nodes`` broadcast slots + 2 extra slots into ``Emits``."""
    times, kinds, pays, enables = bcast
    assert len(extras) == 2
    ex = pack_extras(payload_slots, times.shape[0], times.device, *extras)
    return Emits(
        times=torch.cat([times, ex.times], dim=1),
        kinds=torch.cat([kinds, ex.kinds], dim=1),
        pays=torch.cat([pays, ex.pays], dim=1),
        enables=torch.cat([enables, ex.enables], dim=1),
    )
