"""Carrying engine state across from the reference and back.

``from_numpy_leaves`` builds the port's batched ``EngineState`` from the
reference's, given as numpy arrays in ``jax.tree.leaves`` order with the
typed key as its ``key_data`` (uint32[S, 2]) — the positional leaf order
of the reference's checkpoint format v10 (``leaf_{i}`` /
``leaf_{i}__key``). ``to_numpy_leaves`` goes the other way, and ``first_difference`` names
the first leaf where two states differ. Every leaf's
dtype and trailing shape is checked against the port's own layout for
the workload, so a mismatched state is refused rather than misread.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from . import tree
from .core import EngineConfig, EngineState, Workload, init_sweep


def to_numpy_leaves(state) -> List[np.ndarray]:
    """The state's leaves as numpy arrays, in reference order."""
    return [leaf.detach().cpu().numpy() for leaf in tree.leaves(state)]


def first_difference(a, b) -> Optional[int]:
    """Index of the first leaf whose value, dtype or shape differs between
    two states (``len`` of the shorter one if their leaf counts differ),
    or None when they are equal leaf for leaf."""
    x, y = to_numpy_leaves(a), to_numpy_leaves(b)
    for i, (p, q) in enumerate(zip(x, y)):
        if p.dtype != q.dtype or p.shape != q.shape or not (p == q).all():
            return i
    return None if len(x) == len(y) else min(len(x), len(y))


def from_numpy_leaves(
    leaves: Sequence[np.ndarray], workload: Workload, cfg: EngineConfig, device=None
) -> EngineState:
    """The port's ``EngineState`` holding the given reference leaves."""
    dev = resolve_device(device)
    template = init_sweep(workload, cfg, [0], device="cpu")
    want = tree.leaves(template)
    if len(leaves) != len(want):
        raise ValueError(
            f"expected {len(want)} leaves for this workload, got {len(leaves)}"
        )
    out = []
    for i, (a, w) in enumerate(zip(leaves, want)):
        a = np.asarray(a)
        wdt = w.numpy().dtype
        if a.dtype != wdt or tuple(a.shape[1:]) != tuple(w.shape[1:]):
            raise ValueError(
                f"leaf {i}: expected {wdt}[S, {', '.join(map(str, w.shape[1:]))}], "
                f"got {a.dtype}{list(a.shape)}"
            )
        out.append(torch.from_numpy(np.array(a)).to(dev))  # a writable copy
    return tree.unflatten(template, out)
