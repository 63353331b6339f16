"""Simulate seeds on the plain reference, and check their histories.

``simulate(config, seeds, steps)`` builds the configuration's workload
from its file (``portbench/configs/<name>.json``) on the reference's own
models, runs the lanes on the CPU and returns each lane's state after
exactly its own number of steps, as numpy leaves in ``tree.leaves``
order. Lanes are independent, so a lane's state does not depend on which
other lanes share its batch: a sample of a chunk's lanes re-simulated
alone is that chunk's lanes.
"""

from __future__ import annotations

import importlib
from typing import List, Sequence

import numpy as np
import torch

from .engine import core, tree  # noqa: F401 (tree: for callers)

# the reference steps this many lanes at once (CPU memory and time)
BLOCK = 512


def build(config: dict):
    """``(workload, engine config)`` of a configuration file's contents."""
    mod = importlib.import_module(f"{__package__}.models.{config['model']}")
    cfg = getattr(mod, config["config_class"])(**config["fields"])
    return mod.workload(cfg), mod.engine_config(cfg, **config["engine"])


def host_leaves(state) -> List[np.ndarray]:
    """A state's leaves as numpy arrays (uint32 through int64, exact)."""
    out = []
    for leaf in tree.leaves(state):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.uint32:
            leaf = leaf.to(torch.int64)
        out.append(leaf.numpy())
    return out


def _simulate_block(wl, ecfg, seeds: np.ndarray, steps: np.ndarray, time_bits: int):
    state = core.init_sweep(wl, ecfg, seeds, time_bits=time_bits)
    snaps = [None] * len(seeds)
    at = np.zeros(len(seeds), dtype=np.int64)
    todo = set(range(len(seeds)))

    def take(lanes, k):
        leaves = host_leaves(state)
        for i in lanes:
            snaps[i] = [leaf[i].copy() for leaf in leaves]
            at[i] = k
            todo.discard(i)

    take([i for i in todo if steps[i] == 0], 0)
    k = 0
    while todo:
        state = core.step(wl, ecfg, state, time_bits=time_bits)
        k += 1
        due = [i for i in todo if steps[i] == k]
        if bool(state.done.all()):
            # every lane is frozen from here on: its state at any later
            # step is this one
            due = list(todo)
        if due:
            take(due, k)
    return snaps, at


def simulate(config: dict, seeds: Sequence[int], steps: Sequence[int], time_bits: int = 64,
             taken_at: bool = False):
    """Per lane ``i``: the leaves of seed ``seeds[i]``'s state after
    ``steps[i]`` engine steps (``time_bits=32``: the control's clock).
    Where every lane of a block is done before its steps, the rest are
    not run (a done lane is frozen). ``taken_at=True`` also returns the
    step at which each lane's state was taken."""
    wl, ecfg = build(config)
    seeds = np.asarray(seeds, dtype=np.int64)
    steps = np.asarray(steps, dtype=np.int64)
    out: list = []
    at: list = []
    for lo in range(0, len(seeds), BLOCK):
        snaps, a = _simulate_block(wl, ecfg, seeds[lo:lo + BLOCK], steps[lo:lo + BLOCK], time_bits)
        out += snaps
        at.append(a)
    if taken_at:
        return out, (np.concatenate(at) if at else np.zeros(0, np.int64))
    return out


def template(config: dict):
    """A one-lane initial state: the tree whose leaves ``simulate`` lists."""
    wl, ecfg = build(config)
    return core.init_sweep(wl, ecfg, [0])


def history_verdicts(config: dict, lanes) -> List[bool]:
    """For each lane's leaves (as ``simulate`` returns them): whether its
    decoded history is linearizable under the configuration's spec,
    within its ``max_states`` (an undecided search counts as clean, as the
    program's report counts it)."""
    from .oracle.check import check_history
    from .oracle.history import decode_rows

    check = config["check"]
    mod = importlib.import_module(f"{__package__}.models.{config['model']}")
    spec = mod.history_spec()
    one = template(config)
    names = leaf_names(one)
    idx = {n: i for i, n in enumerate(names)}
    out = []
    for leaves in lanes:
        hist = decode_rows(
            leaves[idx["hist_rec"]], leaves[idx["hist_t"]], int(leaves[idx["hist_len"]]),
            bool(leaves[idx["hist_overflow"]]), seed=int(leaves[idx["seed"]]),
        )
        out.append(check_history(hist, spec, max_states=check["max_states"]).ok)
    return out


def leaf_names(state) -> List[str]:
    """Dotted field names of a state's leaves, in ``tree.leaves`` order
    (the top-level engine fields by their own names)."""
    names: List[str] = []

    def walk(x, path):
        if isinstance(x, tuple):
            fields = getattr(x, "_fields", None) or [str(i) for i in range(len(x))]
            for f, c in zip(fields, x):
                walk(c, f if not path else f"{path}.{f}")
        elif x is not None:
            names.append(path)

    walk(state, "")
    return names

