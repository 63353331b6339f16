"""Fleet-scale checked sweeps: world-size curves + sharded campaigns
(counterpart of ``madsim_tpu/explore/fleet.py``).

- ``checked_sweep_curve``: ONE fixed-spec checked sweep
  (``oracle.screen.checked_sweep``) sharded over each requested world
  size, with aggregate seeds/s, events/s and time-to-first-bug per size
  PLUS the byte-invariance verdict: the merged summary must be
  byte-identical at every world size.
- ``sharded_campaign``: the coverage-guided fault campaign
  (``explore.campaign.run_campaign``) through the sharded pipelined
  driver, with wall-clock, throughput and time-to-first-bug metrics kept
  out of the report bytes.

Both run inside a world of ranks (``parallel.World``): every rank of the
``mesh`` (default: the process group's) calls them with the same
arguments. Where the reference takes a JAX device list, they take world
sizes up to the mesh's and run each on the sub-mesh of ranks
``0..size-1`` (``parallel.sub_mesh``); ranks outside it wait. Every rank
returns rank 0's metrics. Wall-clock numbers live only in the returned
dicts, never in the byte-compared reports.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Optional, Sequence

import numpy as np


def _ttfb_hook(t0: float, box: dict):
    """An ``on_chunk`` callback latching the wall time at which the
    first violating seed became KNOWN (its chunk's host phase merged) —
    the time-to-first-bug clock of a checked sweep or campaign."""

    def on_chunk(*, lo, k, summary) -> None:
        del lo, k
        if box.get("ttfb_s") is None and (
            summary.get("violations", 0) > 0
            or summary.get("hist_violations", 0) > 0
            or summary.get("violating_seeds")
            or summary.get("hist_violating_seeds")
        ):
            box["ttfb_s"] = time.perf_counter() - t0
        box["chunks"] = box.get("chunks", 0) + 1

    return on_chunk


def checked_sweep_curve(
    target,
    base_spec,
    device_counts: Sequence[int] = (1, 2, 4, 8),
    seeds_total: int = 4096,
    seed0: int = 0,
    chunk_per_device: int = 512,
    workers: int = 0,
    warm_seeds: Optional[int] = None,
    mesh=None,
    device=None,
) -> dict:
    """Aggregate checked-sweep throughput vs world size, one fixed fault
    spec (``target.build(base_spec)``), the same seed range at every
    size. Returns per-size metrics plus ``bytes_invariant`` — whether the
    merged summary JSON is identical at every size, though the chunk
    boundaries differ (``chunk_per_device x size``) — computed as the
    reference computes it. ``hist_unique`` counts distinct canonical
    histories PER CHUNK (the reference's ``_HostWork``), so it changes
    with the chunk boundaries whenever one history repeats across them;
    ``invariant_but_hist_unique`` compares the summaries without it.
    Each size first
    sweeps ``warm_seeds`` seeds far above the measured range untimed
    (default: one chunk, plus the ragged tail's chunk; 0 skips it)."""
    from ..oracle.screen import checked_sweep
    from ..parallel.mesh import from_rank0, seed_mesh, sub_mesh

    if mesh is None:
        mesh = seed_mesh(device=device)
    if mesh.size < max(device_counts):
        raise ValueError(
            f"need {max(device_counts)} ranks, the mesh has {mesh.size} "
            "(run inside a parallel.World of that size)"
        )
    workload, ecfg = target.build(base_spec)
    spec = target.hist_spec
    if spec is None:
        raise ValueError(f"target {target.name!r} records no history")
    seeds = np.arange(seed0, seed0 + seeds_total, dtype=np.int64)
    # warm seeds sit far above the measured range (distinct inputs)
    warm_base = seed0 + (1 << 30)

    points = []
    blobs = []
    rests = []
    for n_dev in device_counts:
        sub = sub_mesh(mesh, n_dev)
        point = blob = rest = None
        if sub is not None:
            chunk = chunk_per_device * n_dev
            tail = seeds_total % chunk if seeds_total > chunk else 0
            warm = (
                warm_seeds if warm_seeds is not None
                else (chunk + tail if tail else min(seeds_total, chunk))
            )
            if warm:
                checked_sweep(
                    workload, ecfg, np.arange(warm_base, warm_base + warm, dtype=np.int64),
                    spec, target.summarize, mesh=sub,
                    chunk_per_device=chunk_per_device, workers=workers,
                )
            box: dict = {}
            t0 = time.perf_counter()
            totals = checked_sweep(
                workload, ecfg, seeds, spec, target.summarize, mesh=sub,
                chunk_per_device=chunk_per_device, workers=workers,
                on_chunk=_ttfb_hook(t0, box),
            )
            wall = time.perf_counter() - t0
            blob = json.dumps(totals, sort_keys=True)
            rest = json.dumps(
                {k: v for k, v in totals.items() if k != "hist_unique"}, sort_keys=True
            )
            point = {
                "devices": n_dev,
                "seeds": seeds_total,
                "chunk_per_device": chunk_per_device,
                "wall_s": round(wall, 2),
                "seeds_per_sec": round(seeds_total / wall, 1),
                "events_per_sec": round(totals["events_total"] / wall, 1),
                "time_to_first_bug_s": (
                    round(box["ttfb_s"], 3) if box.get("ttfb_s") else None
                ),
                "suspects": totals.get("hist_suspects", 0),
                "violations": totals.get("hist_violations", 0),
                "chunks": box.get("chunks", 0),
                "report_sha256": hashlib.sha256(blob.encode()).hexdigest(),
            }
        point, blob, rest = from_rank0(mesh, (point, blob, rest))
        points.append(point)
        blobs.append(blob)
        rests.append(rest)
    base = points[0]["seeds_per_sec"]
    for p in points:
        p["speedup"] = round(p["seeds_per_sec"] / base, 2)
    return {
        "metric": "sharded_checked_sweep_curve",
        "target": target.name,
        "workers": workers,
        "curve": points,
        "bytes_invariant": all(b == blobs[0] for b in blobs),
        "invariant_but_hist_unique": all(r == rests[0] for r in rests),
    }


def sharded_campaign(
    target,
    base_spec,
    ccfg,
    n_devices: int,
    report_path: Optional[str] = None,
    ckpt_dir: Optional[str] = None,
    mesh=None,
    device=None,
) -> dict:
    """One coverage-guided fault campaign through the sharded pipelined
    driver on the first ``n_devices`` ranks of the mesh; returns
    throughput metrics (the campaign's own JSONL report — byte-identical
    across world sizes — goes to ``report_path``, written by rank 0)."""
    from ..parallel.mesh import from_rank0, seed_mesh, sub_mesh
    from .campaign import run_campaign

    if mesh is None:
        mesh = seed_mesh(device=device)
    sub = sub_mesh(mesh, n_devices)
    out = None
    if sub is not None:
        box: dict = {}
        t0 = time.perf_counter()
        result = run_campaign(
            target, base_spec, ccfg, report_path=report_path,
            ckpt_dir=ckpt_dir, mesh=sub, on_chunk=_ttfb_hook(t0, box),
        )
        wall = time.perf_counter() - t0
        rounds = len(result.records)
        seeds_swept = rounds * ccfg.seeds_per_round
        events = sum(r["events_total"] for r in result.records)
        out = {
            "metric": "sharded_campaign",
            "target": target.name,
            "devices": n_devices,
            "rounds": rounds,
            "seeds_per_round": ccfg.seeds_per_round,
            "seeds_swept": seeds_swept,
            "wall_s": round(wall, 2),
            "seeds_per_sec": round(seeds_swept / wall, 1),
            "events_per_sec": round(events / wall, 1),
            "events_total": events,
            "violations_total": sum(r["violations"] for r in result.records),
            "distinct_failures": len(result.failures),
            "coverage_total_bits": (
                result.records[-1]["coverage_total_bits"] if result.records else 0
            ),
            "corpus_size": len(result.corpus),
            "time_to_first_bug_s": (
                round(box["ttfb_s"], 3) if box.get("ttfb_s") else None
            ),
        }
        if report_path is not None and sub.rank == 0:
            with open(report_path, "rb") as f:
                out["report_sha256"] = hashlib.sha256(f.read()).hexdigest()
    return from_rank0(mesh, out)
