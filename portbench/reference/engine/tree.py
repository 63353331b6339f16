# The benchmark's plain reference: a frozen copy of madsim_tpu_torch/engine/tree.py, run on the CPU.
# A change to the program's semantics reaches it only through a change to the benchmark.
"""Minimal pytree helpers over NamedTuples/tuples of tensors.

The engine's state is a tree of NamedTuples whose leaves are tensors; the
leaf order is the reference's ``jax.tree.leaves`` order (fields in
declaration order, depth first, an empty tuple contributing nothing), so
``leaves(state)`` lines up index by index with the reference's leaves and
its checkpoint format."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List

import torch


def _is_node(x) -> bool:
    return isinstance(x, tuple)


def _rebuild(node, children):
    if hasattr(node, "_fields"):
        return type(node)(*children)
    return tuple(children)


def leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of ``tree`` in reference order."""
    out: List[torch.Tensor] = []

    def walk(x):
        if _is_node(x):
            for c in x:
                walk(c)
        elif x is not None:
            out.append(x)

    walk(tree)
    return out


def map(fn: Callable[..., Any], tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure."""
    if _is_node(tree):
        return _rebuild(
            tree, [map(fn, c, *(r[i] for r in rest)) for i, c in enumerate(tree)]
        )
    if tree is None:
        return None
    return fn(tree, *rest)


def unflatten(template, new_leaves) -> Any:
    """A tree shaped like ``template`` whose leaves are ``new_leaves``
    (in order)."""
    it: Iterator = iter(new_leaves)

    def build(x):
        if _is_node(x):
            return _rebuild(x, [build(c) for c in x])
        if x is None:
            return None
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out
