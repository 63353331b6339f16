"""The port's entry points (counterpart of the reference's
``__graft_entry__.py``): a one-step check of the flagship and a
multi-rank dry run.

``entry()`` returns one lockstep ``step_batch`` of the flagship (the
MadRaft sweep) with a 64-seed example state. ``dryrun_multichip(n)``
spawns a world of ``n`` ranks (``parallel.World``) and runs the sharded
path end to end on tiny shapes: one explicit sharded step and its live
count, the whole sharded sweep against the unsharded one, the chunked
and sharded composition with a ragged tail, and the checked-sweep curve
of the amnesia gate, whose report must equal at every world size (but
for the reference's per-chunk ``hist_unique``, see ``_dryrun_rank``) and
show violations at each.

Run from the repository root: ``python3 -m madsim_tpu_torch.entry
[n] [--device cpu]`` (default: 2 ranks on CUDA; on a card the ranks sit
round-robin on the visible cards, sharing one over gloo).
"""

from __future__ import annotations

import json
import os
import sys
from functools import partial
from typing import Optional

import numpy as np


def _flagship(tiny: bool = False):
    """The flagship raft workload, its config and engine config (the
    reference's ``_flagship``)."""
    from .models import raft

    if tiny:
        # long enough that nearly every seed elects a leader and commits
        cfg = raft.RaftConfig(
            num_nodes=3,
            crashes=1,
            cmd_window_ns=500_000_000,
            crash_window_ns=500_000_000,
        )
        ecfg = raft.engine_config(
            cfg, queue_capacity=48, time_limit_ns=1_500_000_000, max_steps=6_000
        )
    else:
        cfg = raft.RaftConfig(num_nodes=5, crashes=1)
        ecfg = raft.engine_config(
            cfg, queue_capacity=64, time_limit_ns=10_000_000_000, max_steps=200_000,
        )
    return raft.workload(cfg), cfg, ecfg


def entry(device=None):
    """``(fn, (state,))``: one lockstep engine step over a 64-seed flagship
    batch on ``device`` (None means CUDA)."""
    from . import resolve_device
    from .engine import core

    dev = resolve_device(device)
    wl, _cfg, ecfg = _flagship()
    state = core.init_sweep(wl, ecfg, np.arange(64, dtype=np.int64), device=dev)
    return partial(core.step_batch, wl, ecfg, device=dev), (state,)


def _check(ok: bool, what) -> None:
    """One of the dry run's checks (not an ``assert``: it must hold under
    ``python -O`` too)."""
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _same_leaves(a, b) -> bool:
    from .engine import tree

    return all(
        x.dtype == y.dtype and x.shape == y.shape and bool((x == y).all())
        for x, y in zip(tree.leaves(a), tree.leaves(b))
    )


def _dryrun_rank(mesh, n_devices: int, curve_seeds: int, curve_chunk: int,
                 curve_warm: Optional[int]) -> dict:
    """One rank's share of the dry run (see ``dryrun_multichip``)."""
    from . import parallel
    from .engine import core
    from .explore import checked_sweep_curve
    from .explore.targets import amnesia_gate
    from .models import raft

    wl, _cfg, ecfg = _flagship(tiny=True)
    seeds = np.arange(4 * n_devices, dtype=np.int64)

    # one explicit sharded step...
    state = core.init_sweep(wl, ecfg, parallel.shard_seeds(mesh, seeds), device=mesh.device)
    state, live = parallel.sharded_step(wl, ecfg, mesh)(state, 1)
    _check(live > 0, f"no live seed after one sharded step ({live})")

    # ...then the whole sharded sweep to completion
    final = parallel.run_sweep_sharded(wl, ecfg, seeds, mesh)
    summary = raft.sweep_summary(final)
    _check(summary["seeds"] == 4 * n_devices, summary)
    # real consensus progress, and no violation
    _check(summary["no_leader_seeds"] < summary["seeds"] // 4, summary)
    _check(summary["commits_total"] > 0, summary)
    _check(summary["violations"] == 0, summary)
    # sharding changes no seed's execution: every leaf and the summary
    # equal an unsharded run of the same seeds
    plain = core.run_sweep(wl, ecfg, seeds, device=mesh.device)
    _check(_same_leaves(final, plain), "sharded vs unsharded: a leaf differs")
    _check(summary == raft.sweep_summary(plain), (summary, raft.sweep_summary(plain)))

    # ...the chunked and sharded composition: one full chunk plus a
    # ragged tail padded to mesh divisibility and trimmed
    big = np.arange(7 * n_devices + 3, dtype=np.int64)
    chunked = parallel.run_sweep_sharded_chunked(wl, ecfg, big, mesh, chunk_per_device=4)
    _check(int(chunked.ctr.shape[0]) == big.size, "the ragged tail was not trimmed")
    big_plain = core.run_sweep(wl, ecfg, big, device=mesh.device)
    _check(_same_leaves(chunked, big_plain), "chunked+sharded vs unsharded: a leaf differs")
    _check(raft.sweep_summary(chunked) == raft.sweep_summary(big_plain),
           "chunked+sharded vs unsharded: the summaries differ")

    # ...and the checked sweep of the amnesia gate at a world-size ladder:
    # reports equal at every size, violations at every size. The
    # reference's hist_unique is a per-chunk dedup count, which moves with
    # the chunk boundaries when an election history repeats across them
    # (it does for this gate), so the whole-report bytes_invariant is
    # printed, and every other field is held equal
    counts = tuple(
        c for c in sorted({1, 2, max(2, n_devices // 2), n_devices}) if c <= n_devices
    )
    gate_target, gate_spec = amnesia_gate(smoke=True)
    curve = checked_sweep_curve(
        gate_target, gate_spec, device_counts=counts, seeds_total=curve_seeds,
        chunk_per_device=curve_chunk, warm_seeds=curve_warm, mesh=mesh,
    )
    _check(curve["invariant_but_hist_unique"],
           "checked-sweep reports differ across world sizes beyond hist_unique")
    _check(all(p["violations"] > 0 for p in curve["curve"]),
           f"the amnesia gate spec found no violation: {curve}")
    return {"summary": summary, "counts": counts, "curve": curve}


def dryrun_multichip(
    n_devices: int, device=None, curve_seeds: Optional[int] = None,
    curve_chunk: Optional[int] = None, curve_warm: Optional[int] = None,
    world=None,
) -> dict:
    """Spawn ``n_devices`` ranks on ``device`` (None means CUDA) and run
    the sharded path end to end on tiny shapes (see the module doc);
    any failed check raises. ``curve_seeds``/``curve_chunk`` size the
    checked-sweep curve (defaults: ``MADSIM_MULTICHIP_SEEDS`` and
    ``MADSIM_MULTICHIP_CHUNK``, else 2,048 seeds at 256 per rank, the
    reference's); ``curve_warm`` is the curve's untimed warm-up per world
    size (``checked_sweep_curve``'s ``warm_seeds``; None: one chunk, 0:
    none). ``world`` runs it on an existing ``parallel.World`` of
    ``n_devices`` ranks instead of spawning one. Returns rank 0's summary
    and curve."""
    from . import resolve_device
    from .parallel import World

    dev = resolve_device(device)
    if curve_seeds is None:
        curve_seeds = int(os.environ.get("MADSIM_MULTICHIP_SEEDS", "2048"))
    if curve_chunk is None:
        curve_chunk = int(os.environ.get("MADSIM_MULTICHIP_CHUNK", "256"))
    args = (_dryrun_rank, n_devices, curve_seeds, curve_chunk, curve_warm)
    if world is not None:
        if world.n != n_devices:
            raise ValueError(f"the world has {world.n} ranks, not {n_devices}")
        results = world.run(*args)
    else:
        with World(n_devices, device=dev.type) as spawned:
            results = spawned.run(*args)
    _check(all(r == results[0] for r in results), "ranks returned different results")
    out = results[0]
    print("multichip_curve: " + json.dumps(out["curve"], sort_keys=True))
    print(
        f"dryrun_multichip({n_devices}): ok — sharded==unsharded: true — "
        "chunked==unsharded: true — checked-sweep curve equal but for hist_unique "
        f"across {out['counts']} ranks (bytes_invariant: {out['curve']['bytes_invariant']}) "
        f"— {out['summary']}"
    )
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    dev = None
    if "--device" in args:
        i = args.index("--device")
        dev = args[i + 1]
        del args[i:i + 2]
    dryrun_multichip(int(args[0]) if args else 2, device=dev)
