"""Where one flagship step's time goes, layer by layer, on the card.

Run on a CUDA machine from the repository root:

    python -m madsim_tpu_torch.profile_step [--seeds 16384] [--warm 300] [--reps 20]

It builds the MadRaft flagship state (``RaftConfig(num_nodes=5,
crashes=1)``, queue 64, 3 s horizon), advances it ``--warm`` events, then
times each layer of ``core.step_batch`` called on its own with that
state's inputs — the threefry draws, the pop (with the pop-min kernel),
the raft handler, the push — and the whole step. Per layer it prints one
JSON line: host wall time per call (synchronised), device time per call
(the sum of its kernels' durations in a ``torch.profiler`` trace), the
number of device kernels per call, and the device's idle share of the
wall time. The last line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .engine import core, queue, rng
from .models import raft


def _measure(fn, reps: int) -> dict:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:  # the profiler saw no device activity: say so
        return {"wall_ms": wall_ms, "device_ms": None, "kernels_per_call": None,
                "device_idle_share": None}
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "kernels_per_call": len(kernels) / reps,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=16_384)
    ap.add_argument("--warm", type=int, default=300)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    dev = torch.device("cuda")
    cfg = raft.RaftConfig(num_nodes=5, crashes=1)
    ecfg = raft.engine_config(cfg, queue_capacity=64, time_limit_ns=3_000_000_000)
    wl = raft.workload(cfg)
    s = core.init_sweep(wl, ecfg, torch.arange(args.seeds), device=dev)
    for _ in range(args.warm):
        s = core.step_batch(wl, ecfg, s, device=dev)
    rand = rng.event_bits(s.key, s.ctr, wl.num_rand + 2)
    q, t, kind, pay, found = queue.pop_min(s.queue, enable=~s.done, tie_u32=rand[:, 1])
    now = torch.maximum(s.now_ns, torch.where(found, t, s.now_ns)) + 75
    _w, emits = wl.handle(s.wstate, now, kind, pay, rand[:, 2:])
    layers = {
        "rng.event_bits": lambda: rng.event_bits(s.key, s.ctr, wl.num_rand + 2),
        "queue.pop_min": lambda: queue.pop_min(s.queue, enable=~s.done, tie_u32=rand[:, 1]),
        "raft.handle": lambda: wl.handle(s.wstate, now, kind, pay, rand[:, 2:]),
        "queue.push_many": lambda: queue.push_many(
            q, emits.times, emits.kinds, emits.pays, emits.enables),
        "core.step_batch": lambda: core.step_batch(wl, ecfg, s, device=dev),
    }
    for name, fn in layers.items():
        row = {"layer": name, "seeds": args.seeds, **_measure(fn, args.reps)}
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())


if __name__ == "__main__":
    main()
