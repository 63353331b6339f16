"""What every cell of the port's benchmark shares: finding a cell's pieces
by name, the lanes a run hands to the reference, the comparison that
decides ``correct``, the profiled sub-window of a traced run, and the
result line.

A cell is one entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs/<config>.json``) under a traffic mix (``traffic/<traffic>.json``),
whose ``driver`` names the file under ``drivers/`` that runs the window.
A per-layer metric is read by ``metrics/<name>.py`` from the records the
driver leaves. Adding a cell, a configuration, a traffic mix, a driver or
a metric adds files; none of these is edited.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)

# modules that no run may hold once its window has closed, compared by
# whole top-level name (the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "madsim_tpu")

# published HBM bandwidth of one H100 SXM (NVIDIA's data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12

# steps of a traced run's sub-windows (unprofiled, for the wall per step;
# profiled), and calls of the handler's
STEPS_TIMED = 64
STEPS_PROFILED = 16
HANDLER_REPS = 20
BREAKDOWN_ENTRIES = 10


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_piece(kind: str, name: str, pkg: str = PKG) -> dict:
    """``<kind>/<name>.json`` under the harness (a configuration or a
    traffic mix)."""
    with open(os.path.join(pkg, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str, pkg: str = PKG):
    """``<kind>/<name>.py`` under the harness as a module (a driver or a
    metric reader; metric names carry dots, so by path, not by import)."""
    path = os.path.join(pkg, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str) -> Dict[str, List[dict]]:
    """The end-to-end and per-layer metrics ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": per_layer}


def seed_base(seed: int, stride: int) -> int:
    """The first seed of a run: ``seed * stride`` as a wrapped int64."""
    v = (int(seed) * int(stride)) % (1 << 64)
    return v - (1 << 64) if v >= 1 << 63 else v


@dataclass
class Context:
    """One run of one cell, as the driver sees it."""

    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    lanes: int = 0
    records: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.lanes:
            self.lanes = int(self.traffic["lanes"])

    def chunk_seeds(self, c: int) -> np.ndarray:
        """The seeds of chunk ``c`` of this run (int64, wrapping)."""
        base = np.int64(seed_base(self.seed, self.traffic["seed_stride"]))
        with np.errstate(over="ignore"):
            return base + np.int64(c * self.lanes) + np.arange(self.lanes, dtype=np.int64)

    def rng(self) -> np.random.Generator:
        return np.random.default_rng(int(self.seed) % (1 << 63))


@dataclass
class Outcome:
    """What a driver's run hands back: its end-to-end numbers, the lanes
    to compare with the reference, and the counts of its window."""

    end_to_end: Dict[str, float]
    groups: List[dict]
    attempted: int
    memory_peak_bytes: int
    checks: Dict[str, dict] = field(default_factory=dict)


def pin_host(device) -> None:
    """Hold the calling thread, the one that launches the window's work,
    to one CPU core, and torch's own CPU work to one thread, so that the
    scheduler neither moves the launching thread between cores nor lets
    torch's thread pool compete with it. A driver calls it once its
    set-up has started every helper process (those keep every core).
    Only on a CUDA device: the CPU tests share their cores."""
    import torch

    if torch.device(device).type != "cuda":
        return
    torch.set_num_threads(1)
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})


# -- lanes handed to the reference -------------------------------------------


class LaneSample:
    """Lanes of the program's states, gathered on the device as they are
    produced and copied to the host once the window has closed. Each group
    is one chunk's lanes after a known number of steps."""

    def __init__(self, per_chunk: int, rng: np.random.Generator):
        self.per_chunk = per_chunk
        self.rng = rng
        self.groups: List[dict] = []

    def take(self, state, steps: int, *, longest=None, verdicts=None) -> None:
        """Gather ``per_chunk`` lanes drawn from the seed, and the lane at
        index tensor ``longest`` (the chunk's longest run), of ``state``."""
        import torch

        from madsim_tpu_torch.engine import tree

        s = int(state.seed.shape[0])
        pick = self.rng.choice(s, size=min(self.per_chunk, s), replace=False)
        idx = torch.as_tensor(np.sort(pick), dtype=torch.int64).to(state.seed.device)
        if longest is not None:
            idx = torch.cat([idx, longest.reshape(1).to(torch.int64)])
        self.groups.append({
            "steps": int(steps),
            "idx": idx,
            # uint32 leaves gathered through int64 (exact; torch has no
            # uint32 gather), their dtype kept beside them
            "lanes": tree.map(
                lambda a: (a.to(torch.int64) if a.dtype == torch.uint32 else a)
                .index_select(0, idx), state),
            "dtypes": [str(a.dtype) for a in tree.leaves(state)],
            "verdicts": verdicts,
        })

    def to_host(self) -> List[dict]:
        """Each group as ``{seeds, steps, leaves, dtypes, verdicts}`` on the
        host, with repeated lanes dropped."""
        from madsim_tpu_torch.engine import tree

        out = []
        for g in self.groups:
            _, first = np.unique(g["idx"].cpu().numpy(), return_index=True)
            keep = np.sort(first)
            leaves = [leaf.cpu().numpy()[keep] for leaf in tree.leaves(g["lanes"])]
            seeds = leaves[0]
            verdicts = g["verdicts"]
            out.append({
                "seeds": seeds,
                "steps": np.full(len(keep), g["steps"], dtype=np.int64),
                "leaves": leaves,
                "dtypes": g["dtypes"],
                "verdicts": None if verdicts is None else verdicts(seeds),
            })
        return out


def compare(config: dict, groups: List[dict], ref=None) -> dict:
    """Re-simulate every lane of ``groups`` on the reference and compare
    it with the program's, every leaf; where the configuration checks
    histories, compare the program's verdict on each lane with the
    reference's own decode and WGL check. Returns the numbers compared.
    ``ref`` is the reference's lanes where they were simulated already."""
    from portbench.reference import sim

    if ref is None:
        ref = sim.simulate(config, _cat(groups, "seeds"), _cat(groups, "steps"))
    one = sim.template(config)
    names = sim.leaf_names(one)
    dtypes = [str(a.dtype) for a in sim.tree.leaves(one)]
    prog = [leaf for g in groups for leaf in _lanes_of(g)]
    wrong_dtype = sorted({f"dtype of {n}" for g in groups
                          for n, a, b in zip(names, g["dtypes"], dtypes) if a != b})
    bad_lanes = 0
    bad_leaves: Dict[str, int] = {}
    for p, r in zip(prog, ref):
        diff = [n for n, a, b in zip(names, p, r)
                if a.shape != b.shape or not np.array_equal(a, b)]
        if len(p) != len(r):
            diff.append("leaf count")
        diff += wrong_dtype
        bad_lanes += bool(diff)
        for n in diff:
            bad_leaves[n] = bad_leaves.get(n, 0) + 1
    out = {
        "lanes_compared": {"value": len(ref), "min": 1},
        "lanes_mismatched": {"value": bad_lanes, "limit": 0},
    }
    if bad_leaves:
        out["lanes_mismatched"]["leaves"] = dict(sorted(bad_leaves.items(), key=lambda kv: -kv[1])[:8])
    if config.get("check") and any(g["verdicts"] is not None for g in groups):
        ok_ref = np.asarray(sim.history_verdicts(config, ref), bool)
        prog_bad = np.concatenate([g["verdicts"] for g in groups]).astype(bool)
        wrong = int(np.sum(prog_bad == ok_ref))
        out["verdicts_mismatched"] = {"value": wrong, "limit": 0}
    return out


def control(config: dict, groups: List[dict]) -> dict:
    """The control's reading on the lanes of ``groups``: the reference
    with every clock value and deadline held in 32 bits (the width below
    the configuration's int64 nanoseconds) put in the program's place,
    its own decode and WGL check giving its verdicts, compared with the
    reference as a run compares the program. Each lane runs no further
    than the reference's lane needed: a lane still live there differs."""
    from portbench.reference import sim

    seeds, steps = _cat(groups, "seeds"), _cat(groups, "steps")
    ref, at = sim.simulate(config, seeds, steps, taken_at=True)
    ctl = sim.simulate(config, seeds, np.minimum(steps, at), time_bits=32)
    verdicts = None
    if config.get("check"):
        verdicts = (~np.asarray(sim.history_verdicts(config, ctl), bool)).astype(np.int64)
    like = sim.tree.leaves(sim.template(config))
    group = {
        "seeds": seeds, "steps": steps,
        "leaves": [np.stack([lane[j] for lane in ctl]) for j in range(len(like))],
        "dtypes": [str(a.dtype) for a in like],
        "verdicts": verdicts,
    }
    return compare(config, [group], ref=ref)


def _cat(groups: List[dict], key: str) -> np.ndarray:
    return np.concatenate([g[key] for g in groups]) if groups else np.zeros(0, np.int64)


def _lanes_of(group: dict):
    n = len(group["seeds"])
    return [[leaf[i] for leaf in group["leaves"]] for i in range(n)]


def within_limits(compared: dict) -> bool:
    """Every compared number within its limit (``limit``: at most;
    ``min``: at least)."""
    for v in compared.values():
        if "limit" in v and v["value"] > v["limit"]:
            return False
        if "min" in v and v["value"] < v["min"]:
            return False
    return True


# -- the traced run's sub-window ---------------------------------------------


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profile_steps(wl, ecfg, state, device, steps: int = STEPS_PROFILED,
                  timed: int = STEPS_TIMED):
    """Step ``state`` ``timed`` times unprofiled (the wall per step), then
    ``steps`` times under ``torch.profiler`` (device activity, kernels and
    what the host ran in each idle gap). Returns ``(record, state)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from madsim_tpu_torch.engine import core

    _sync(device)
    t0 = time.perf_counter()
    for _ in range(timed):
        state = core.step_batch(wl, ecfg, state, device=device)
    _sync(device)
    wall_plain = (time.perf_counter() - t0) * steps / timed
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            with record_function("step_batch"):
                state = core.step_batch(wl, ecfg, state, device=device)
        _sync(device)
        wall_traced = time.perf_counter() - t0
    events = prof.events()
    # the device timeline also carries each record_function range as an
    # annotation spanning its step: that is no device work
    dev_ops = sorted(
        ((e.time_range.start, e.time_range.end, e.name) for e in events
         if e.device_type == DeviceType.CUDA and e.name != "step_batch"),
        key=lambda x: x[0],
    )
    host_ops = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in events
        if e.device_type == DeviceType.CPU and e.cpu_parent is not None
        and e.cpu_parent.name == "step_batch"
    )
    record = {
        "steps": steps,
        "lanes": int(state.seed.shape[0]),
        "queue": int(ecfg.queue_capacity),
        "wall_plain_s": wall_plain,  # as many steps as profiled
        "wall_traced_s": wall_traced,
        "device_ops": len(dev_ops),
    }
    record.update(_device_time(dev_ops, host_ops))
    return record, state


def _device_time(dev_ops, host_ops) -> dict:
    """Busy time (the union of device intervals), time by op name, the
    pop-min kernel's mean, and idle gaps by the host op they fell in."""
    busy_us = 0.0
    by_name: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    pop = []
    starts = [h[0] for h in host_ops]
    end = None
    for s, e, name in dev_ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if "pop_min" in name:
            pop.append(e - s)
        if end is None or s >= end:
            if end is not None and s > end:
                mid = 0.5 * (s + end)
                j = bisect.bisect_right(starts, mid) - 1
                label = host_ops[j][2] if j >= 0 and host_ops[j][1] >= mid else "python between ops"
                gaps[label] = gaps.get(label, 0.0) + (s - end) * 1e-6
            busy_us += e - s
            end = e
        elif e > end:
            busy_us += e - end
            end = e
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    return {
        "busy_s": busy_us * 1e-6,
        "device_ops_s": [[n[:160], v * 1e-6] for n, v in top],
        "idle_gaps_s": sorted(([k[:160], v] for k, v in gaps.items()),
                              key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES],
        "pop_min_mean_s": (sum(pop) / len(pop) * 1e-6) if pop else None,
        "pop_min_launches": len(pop),
    }


def profile_handler(wl, state, device, reps: int = HANDLER_REPS) -> Optional[float]:
    """Device seconds per call of the workload's handler on ``state``'s
    inputs (``profile_step``'s method: the handler called on its own,
    ``reps`` times under the profiler); None where no device op ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from madsim_tpu_torch.engine import queue, rng

    if torch.device(device).type != "cuda":
        return None
    rand = rng.event_bits(state.key, state.ctr, wl.num_rand + 2)
    _q, t, kind, pay, found = queue.pop_min(state.queue, enable=~state.done, tie_u32=rand[:, 1])
    now = torch.maximum(state.now_ns, torch.where(found, t, state.now_ns)) + 75
    args = (state.wstate, now, kind, pay, rand[:, 2:])
    wl.handle(*args)
    _sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            wl.handle(*args)
        _sync(device)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    return sum(e.time_range.elapsed_us() for e in kernels) * 1e-6 / reps


def pop_min_bound_s(lanes: int, queue: int) -> float:
    """Least time of one pop-min decision: its time plane read once
    (``S x Q x 8`` B), the tie words read and slot and found written
    (``S x 9`` B), over HBM bandwidth."""
    return (lanes * queue * 8 + lanes * 9) / HBM_BYTES_PER_S


def breakdown(profile_rec: dict) -> dict:
    return {"device_ops": profile_rec["device_ops_s"], "idle_gaps": profile_rec["idle_gaps_s"]}


# -- the run's device and result line ----------------------------------------


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def device_info(device, memory_peak_bytes: int, profile_rec: Optional[dict]) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1}
    else:
        info = {"platform": dev.type, "kind": dev.type, "count": 1}
    info["memory_peak_bytes"] = int(memory_peak_bytes)
    if profile_rec is not None:
        info["busy_s"] = profile_rec["busy_s"]
        info["window_s"] = profile_rec["wall_traced_s"]
    limit = power_limit() if dev.type == "cuda" else None
    if limit:
        info["power_limit"] = limit
    return info


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def read_metrics(metrics: List[dict], records: dict, pkg: str = PKG) -> Dict[str, dict]:
    """Each per-layer metric's reader over the run's records; a reader
    that finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = load_module("metrics", m["name"], pkg).read(records)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
