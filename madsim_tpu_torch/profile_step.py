"""Where one step's time goes, phase by phase, on the card.

Run on a CUDA machine from the repository root:

    python -m madsim_tpu_torch.profile_step [--model raft] [--seeds 16384] [--warm 300] [--reps 20]

It builds a model's sweep state — ``raft``: the MadRaft flagship
(``RaftConfig(num_nodes=5, crashes=1)``, queue 64, 3 s horizon);
``kafka``: ``KafkaConfig()`` at 3 s (queue 48); ``s3``: ``S3Config()``
at its defaults (5 s, queue 48); ``etcd``: ``EtcdConfig(hist_slots=256)``
at 2 s (queue 48) — advances it ``--warm`` events, then runs ``--reps``
steps of ``core.step_batch`` in a loop under ``torch.profiler``. The
step's six phase ranges (``step.draws``, ``step.pop``, ``step.handler``,
``step.push``, ``step.planes``, ``step.select``; ``engine/core._span``)
tile it, so per phase it prints one JSON line, each number per step:
the host ms (the range's CPU duration), the device ms and the number of
device operations launched under the range (those of the torch ops
inside it), and the device's idle ms whose gap's middle fell inside the
range. A line for the whole step follows: the host's wall, the device's
busy time (the union of its operations), its operations, the idle ms
that fell outside every phase, and the count of device-timeline events
named as a phase (0: the ranges are host-side only). The last line is
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import bisect
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .engine import core
from .models import etcd, kafka, raft, s3

PHASE = "step."


def _model(name: str):
    """(workload, engine config) of a model's profiled sweep."""
    if name == "raft":
        cfg = raft.RaftConfig(num_nodes=5, crashes=1)
        return raft.workload(cfg), raft.engine_config(
            cfg, queue_capacity=64, time_limit_ns=3_000_000_000)
    if name == "kafka":
        cfg = kafka.KafkaConfig()
        return kafka.workload(cfg), kafka.engine_config(cfg, time_limit_ns=3_000_000_000)
    if name == "s3":
        cfg = s3.S3Config()
        return s3.workload(cfg), s3.engine_config(cfg)
    cfg = etcd.EtcdConfig(hist_slots=256)
    return etcd.workload(cfg), etcd.engine_config(cfg, time_limit_ns=2_000_000_000)


def _launched(event):
    """(device us, operations) of every device operation launched by the
    torch ops under the host event ``event``."""
    us, n = 0.0, 0
    stack = [event]
    while stack:
        e = stack.pop()
        for k in e.kernels:
            us += k.duration
            n += 1
        stack.extend(e.cpu_children)
    return us, n


def phases(events, reps: int) -> list:
    """One row per phase range of ``events`` (a profile's ``events()``) and
    a last row for the whole window, every number per step."""
    ranges = sorted((e for e in events if e.device_type == DeviceType.CPU
                     and e.name.startswith(PHASE)), key=lambda e: e.time_range.start)
    device = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == DeviceType.CUDA and not e.name.startswith(PHASE))
    rows = {}
    for r in ranges:
        row = rows.setdefault(r.name, {"phase": r.name, "host_us": 0.0, "device_us": 0.0,
                                       "ops": 0, "idle_us": 0.0})
        row["host_us"] += r.time_range.elapsed_us()
        us, n = _launched(r)
        row["device_us"] += us
        row["ops"] += n
    starts = [r.time_range.start for r in ranges]
    busy_us = outside_us = 0.0
    end = None
    for s, e in device:
        if end is not None and s > end:
            mid = 0.5 * (s + end)
            j = bisect.bisect_right(starts, mid) - 1
            if j >= 0 and ranges[j].time_range.end >= mid:
                rows[ranges[j].name]["idle_us"] += s - end
            else:
                outside_us += s - end
        if end is None or s >= end:
            busy_us += e - s
            end = e
        elif e > end:
            busy_us += e - end
            end = e
    out = [{"phase": row["phase"], "host_ms": row["host_us"] / reps / 1e3,
            "device_ms": row["device_us"] / reps / 1e3, "ops": row["ops"] / reps,
            "idle_ms": row["idle_us"] / reps / 1e3} for row in rows.values()]
    out.append({"phase": "step", "device_ms": busy_us / reps / 1e3,
                "ops": len(device) / reps, "idle_ms_outside_phases": outside_us / reps / 1e3,
                "mirrored_phase_events": sum(1 for e in events if e.device_type == DeviceType.CUDA
                                             and e.name.startswith(PHASE))})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("raft", "kafka", "s3", "etcd"), default="raft")
    ap.add_argument("--seeds", type=int, default=16_384)
    ap.add_argument("--warm", type=int, default=300)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    dev = torch.device("cuda")
    wl, ecfg = _model(args.model)
    s = core.init_sweep(wl, ecfg, torch.arange(args.seeds), device=dev)
    for _ in range(args.warm):
        s = core.step_batch(wl, ecfg, s, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            s = core.step_batch(wl, ecfg, s, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / args.reps * 1e3
    rows = phases(prof.events(), args.reps)
    rows[-1]["wall_ms"] = wall_ms
    for row in rows:
        print(json.dumps({"model": args.model, "seeds": args.seeds, **row}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())


if __name__ == "__main__":
    main()
