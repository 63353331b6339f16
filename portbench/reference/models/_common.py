# The benchmark's plain reference: a frozen copy of madsim_tpu_torch/models/_common.py, run on the CPU.
# A change to the program's semantics reaches it only through a change to the benchmark.
"""Shared emit-packing helpers for the batched models (counterpart of
``madsim_tpu/models/_common.py``).

Every handler emits a fixed shape per seed: ``num_nodes`` broadcast slots
followed by two "extra" slots (timer re-arms, unicast replies).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..engine import tree
from ..engine.core import Emits
from ..engine.ops import expand, where

# sentinel for an unused extra slot
DISABLED = None


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


def switch(kind, branches, w, *args):
    """The batched ``lax.switch`` of a handler: every branch
    ``branch(w, *args) -> (w', Emits)`` runs for the whole batch and each
    lane keeps branch ``kind``'s result (``kind`` clamped into range, as
    ``lax.switch`` clamps it)."""
    results = [br(w, *args) for br in branches]
    kind = torch.clamp(kind, 0, len(branches) - 1)
    return (
        _select(kind, w, [r[0] for r in results]),
        _select(kind, results[0][1], [r[1] for r in results]),
    )


def _select(kind, base, results):
    """Per lane, ``results[kind]``. A leaf a branch did not touch is
    ``base``'s own tensor and needs no select for that branch."""
    masks = [kind == k for k in range(len(results))]
    per_branch = [tree.leaves(r) for r in results]
    out = []
    for i, b in enumerate(tree.leaves(base)):
        acc = b
        for k, leaves in enumerate(per_branch):
            leaf = leaves[i]
            if leaf is not b:
                acc = where(expand(masks[k], leaf.ndim), leaf, acc)
        out.append(acc)
    return tree.unflatten(base, out)
