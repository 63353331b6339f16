"""Million-seed MadRaft sweep — the scale demonstration (counterpart of
``scripts/sweep_million.py``).

Runs 2**20 = 1,048,576 seeds of BASELINE config #3 (5-node Raft election
+ replication with crash/restart injection, 3 virtual seconds each) as
16k chunks on ``--device`` (default CUDA), merging per-chunk summaries on
the host (constant device memory — the pattern that extends
indefinitely). Prints one JSON line.

Any total works: a ragged final chunk is padded to the full chunk size
and its summary is computed through the limit-masked reduction
(``models/_common.make_sweep_summary(limit=)``), as the reference does,
so the totals equal the reference's at every total.
``compiles_in_timed_region`` counts what ``engine/compiles.count_compiles``
counts while the timed loop runs: kernel builds, library loads and
``core.drive``'s step-graph captures. The warm-up before the timed loop
runs ``core.GRAPH_STEPS`` steps at each width the loop runs: the chunk's,
and with ``ckpt_dir`` a ragged tail's, which the resumable sweep runs
unpadded (on a card that builds and loads the pop-min kernel and
captures the step graph each chunk replays), and both summaries a
ragged tail needs; after it the count is 0.

Usage, from the repository root:
    python -m madsim_tpu_torch.scripts.sweep_million [total_seeds] [ckpt_dir] [--mesh [N]] [--device D]

``MADSIM_SWEEP_CHUNK`` sets the chunk size (default 16384). Progress goes
to stderr as an obs-registry heartbeat (seeds done, seeds/s, ETA) every
``MADSIM_HB_SECONDS`` (default 5; 0 disables) — stdout stays the single
machine-readable JSON line.

With ``ckpt_dir`` the sweep is preemption-safe: per-chunk summaries are
checkpointed (``engine.checkpoint.run_sweep_chunked_resumable``) and a
restarted run skips completed chunks.

``--mesh`` (``--mesh N`` for N ranks; bare ``--mesh`` picks 8) runs every
chunk sharded over a world of N ranks (``parallel.World`` and
``parallel.run_sweep_sharded``) — the same chunk granule spans all ranks,
summaries merge identically, and the per-chunk checkpoint files do not
depend on the mesh, so a sweep can be interrupted under one world size
and finished under another. Ranks sit round-robin on the visible cards
(sharing one over gloo) or run on the CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

from . import _cli

BASE = 1 << 30


def chunk_size() -> int:
    """``MADSIM_SWEEP_CHUNK`` (default 16384): smoke runs exercise the
    multi-chunk and ragged paths without 16k-lane chunks."""
    return int(os.environ.get("MADSIM_SWEEP_CHUNK", 16384))


def _flagship():
    from ..models import raft

    cfg = raft.RaftConfig(num_nodes=5, crashes=1)
    ecfg = raft.engine_config(cfg, time_limit_ns=3_000_000_000)
    return raft.workload(cfg), ecfg


def sweep(mesh, total: int, ckpt_dir, chunk: int, n_dev: int, device) -> dict:
    """The sweep on this process (``mesh`` None) or on one rank of a
    world (every rank runs it; all return the same line)."""
    import numpy as np

    from .. import obs
    from ..engine import core
    from ..engine.compiles import count_compiles
    from ..models import raft
    from ..models._common import merge_summaries

    dev = mesh.device if mesh is not None else device
    wl, ecfg = _flagship()

    def run_chunk(seed_chunk, cfg=ecfg):
        if mesh is None:
            return core.run_sweep(wl, cfg, seed_chunk, device=dev)
        from ..parallel import run_sweep_sharded

        return run_sweep_sharded(wl, cfg, seed_chunk, mesh)

    def arange(lo: int, hi: int):
        return np.arange(lo, hi, dtype=np.int64)

    tail = total % chunk if total > chunk else 0

    # warm-up outside the timed region: one step graph's steps at each
    # width the timed loop runs (the kernel's build and load and, on a
    # card, the capture of drive's step graph for that width; the
    # resumable sweep runs a ragged tail unpadded, at a width of its own)
    # and the summaries the timed loop calls, the limit-masked one a
    # ragged tail hits included
    warm_n = min(total, chunk)
    warm_cfg = ecfg._replace(max_steps=core.GRAPH_STEPS)
    if ckpt_dir and tail:
        run_chunk(arange(BASE - tail, BASE), warm_cfg)
    warm = run_chunk(arange(BASE - warm_n, BASE), warm_cfg)
    raft.sweep_summary(warm)
    if tail:
        raft.sweep_summary(warm, limit=min(tail, warm_n))
    del warm

    # progress heartbeat driven by the obs registry: the chunk drivers
    # count ``sweep_seeds_done_total`` as each chunk lands, and a daemon
    # ticker reads it back (rank 0 alone on a mesh)
    telem = obs.Telemetry()
    rank0 = mesh is None or mesh.rank == 0
    if rank0:
        hb, stop = _cli.heartbeat(telem.registry, total, prefix="sweep")
    chunks_preloaded = 0
    try:
        with count_compiles() as compiles:
            t0 = time.perf_counter()
            if ckpt_dir:
                from ..engine.checkpoint import run_sweep_chunked_resumable

                chunks_preloaded = len(glob.glob(os.path.join(ckpt_dir, "chunk_*.json")))
                # the chunk granule clamped to the total, so a sub-chunk
                # run is not padded up to a full chunk
                totals = run_sweep_chunked_resumable(
                    wl, ecfg, arange(BASE, BASE + total), raft.sweep_summary, ckpt_dir,
                    chunk_size=min(chunk, total), run_chunk=run_chunk,
                    telemetry=telem, device=dev,
                )
            else:
                totals = {}
                for lo in range(BASE, BASE + total, chunk):
                    k = min(chunk, BASE + total - lo)
                    if k < chunk and total > chunk:
                        # ragged tail: the contiguous seed range extended
                        # to the chunk shape (value-identical to
                        # core._pad_seeds' max+1+i filler), the padded
                        # lanes masked in the summary
                        final = run_chunk(arange(lo, lo + chunk))
                        merge_summaries(totals, raft.sweep_summary(final, limit=k))
                    else:
                        final = run_chunk(arange(lo, lo + k))
                        merge_summaries(totals, raft.sweep_summary(final))
                    del final
                    telem.count(
                        "sweep_seeds_done_total", k,
                        help="seeds retired across all chunks",
                    )
            wall = time.perf_counter() - t0
    finally:
        if rank0:
            stop()
    if rank0:
        hb.tick(force=True)

    return {
        "metric": "madraft_million_seed_sweep",
        "seeds": total,
        "chunk_size": chunk,
        "wall_s": round(wall, 2),
        "seeds_per_sec": round(total / wall, 1),
        "events_per_sec": round(totals["events_total"] / wall, 1),
        "sim_sec_per_wall_sec": round(totals["sim_ns_total"] / wall / 1e9, 1),
        "violations": totals["violations"],
        "elections_total": totals["elections_total"],
        # provenance: throughput above is only a device measurement when
        # every chunk was computed this run
        "chunks_loaded_from_checkpoint": chunks_preloaded,
        "chunks_computed": -(-total // chunk) - chunks_preloaded,
        # kernel builds and library loads during the timed loop (0 = the
        # warm-up paid for everything, ragged tail included)
        "compiles_in_timed_region": compiles.count,
        "mesh_devices": n_dev,
        "backend": _cli.device_name(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sweep_million")
    ap.add_argument("total", type=int, nargs="?", default=1 << 20)
    ap.add_argument("ckpt_dir", nargs="?", default=None)
    ap.add_argument("--mesh", type=int, nargs="?", const=8, default=None,
                    help="shard each chunk over a world of N ranks "
                         "(bare --mesh picks 8)")
    _cli.add_device(ap)
    ns = ap.parse_args(argv)
    dev = _cli.device(ns, ap.prog)
    chunk = chunk_size()
    total = ns.total
    if ns.mesh is None:
        out = sweep(None, total, ns.ckpt_dir, chunk, 0, dev)
    else:
        n_dev = ns.mesh
        if chunk % n_dev or total % n_dev:
            raise SystemExit(
                f"chunk {chunk} and total {total} must divide the {n_dev}-rank mesh"
            )
        from ..parallel import World
        from . import sweep_million as this  # the ranks import it by name

        with World(n_dev, device=dev.type) as world:
            out = world.run(this.sweep, total, ns.ckpt_dir, chunk, n_dev, None)[0]
    _cli.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
