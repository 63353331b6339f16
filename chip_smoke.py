#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``madsim_tpu_torch``) on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs a CUDA card and the repository's ``madsim_tpu_torch`` package;
without either it exits non-zero and prints no result. It imports
neither JAX nor ``madsim_tpu``.

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device and build: the card's name and power limit, then the pop-min
   kernel built from ``madsim_tpu_torch/csrc/pop_min.cu`` with nvcc;
2. the kernel against its plain torch version on the card, at the main
   path's shape (16,384 seeds x 64 slots): flagship queues after 300
   events (real ties), empty queues and full queues with heavy ties —
   slot and found must be exactly equal; the kernel's and the plain
   version's device times from CUDA graphs of back-to-back calls timed
   by CUDA events, with the kernel's ``torch.profiler`` duration and the
   host-paced times printed beside them;
3. the main path: the MadRaft flagship (``RaftConfig(num_nodes=5,
   crashes=1)``, queue 64, 3 s horizon, 200,000 max steps) over 16,384
   seeds through ``core.run_sweep(..., device="cuda")``. The kernel's
   launch count is zeroed just before and must equal the number of
   ``step_batch`` calls just after;
4. cross-device parity: seeds 0-63 through the port on the CPU equal
   lanes 0-63 of the GPU state leaf for leaf, and the GPU run's
   ``sweep_summary(limit=64)`` equals the JAX-made golden summary
   ``madsim_tpu_torch/data/flagship_summary.json``;
5. replay: ``run_traced`` of one seed on the card equals the CPU replay.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

NUM_SEEDS = 16_384
CAPACITY = 64
HORIZON_NS = 3_000_000_000
MAX_STEPS = 200_000
PARITY_SEEDS = 64
REPLAY_SEED = 5
# H100 SXM peaks from the data sheet: HBM bandwidth, and the 32-bit rate
# outside the tensor cores (the kernel's hash and compares are 32/64-bit
# integer work on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
# integer operations per slot: the murmur finalizer (2 multiplies, 3
# shifts, 3 xors, the iota multiply and xor) and the 3-way compare/select
OPS_PER_SLOT = 14


def log(msg: str) -> None:
    print(msg, flush=True)


def _event_ms(run, reps: int, rounds: int) -> float:
    """Median over ``rounds`` of CUDA-event time around ``run()``, per rep."""
    import torch

    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def time_ms(fn, reps: int, rounds: int = 5) -> float:
    """Wall time per ``fn()`` call on the card's clock, by CUDA events
    around ``reps`` back-to-back calls from the host. A call whose host
    work outlasts its device work is timed at the host's pace."""
    import torch

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    return _event_ms(run, reps, rounds)


def graph_ms(fn, reps: int, rounds: int = 5) -> float:
    """Device time per ``fn()`` call with the host out of the loop:
    ``reps`` calls captured in one CUDA graph, replayed between CUDA
    events (median of ``rounds``). ``fn`` must launch on the current
    stream."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up off the default stream, as capture requires
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _event_ms(graph.replay, reps, rounds)


def profiled_kernel_ms(fn, reps: int, kernel: str):
    """Mean duration of the device kernels named ``kernel`` in a
    ``torch.profiler`` trace of ``reps`` calls (None if it saw none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    if not events:
        return None
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / len(events)


def flagship():
    from madsim_tpu_torch.models import raft

    cfg = raft.RaftConfig(num_nodes=5, crashes=1)
    ecfg = raft.engine_config(
        cfg, queue_capacity=CAPACITY, time_limit_ns=HORIZON_NS, max_steps=MAX_STEPS
    )
    return raft.workload(cfg), ecfg


def kernel_cases(dev, num_seeds: int):
    """(name, time [S, Q], tie [S]) inputs at the main path's shape."""
    import torch

    from madsim_tpu_torch.engine import core, cuda_queue, rng

    wl, ecfg = flagship()
    state = core.init_sweep(wl, ecfg, torch.arange(num_seeds), device=dev)
    for _ in range(300):
        state = core.step_batch(wl, ecfg, state, device=dev)
    # the tie-break draw the next event would use
    tie = rng.event_bits(state.key, state.ctr, wl.num_rand + 2)[:, 1]
    words = rng.bits(rng.seed_key(torch.arange(num_seeds, device=dev) + 99), 3)
    heavy = (words[:, :1] + torch.arange(CAPACITY, device=dev)) % 3  # 3-way ties
    inv = cuda_queue.INVALID_TIME
    return [
        ("flagship_after_300_events", state.queue.time.contiguous(), tie),
        ("empty", torch.full((num_seeds, CAPACITY), inv, dtype=torch.int64, device=dev),
         words[:, 1]),
        ("full_heavy_ties", heavy.contiguous(), words[:, 2]),
    ]


def phase_kernel(dev, num_seeds: int = NUM_SEEDS) -> dict:
    """The kernel against its plain version on the same inputs."""
    import torch

    from madsim_tpu_torch.engine import cuda_queue

    worst = 0
    cases = kernel_cases(dev, num_seeds)
    for name, time_plane, tie in cases:
        slot, found = cuda_queue.pop_min_decision(time_plane, tie)
        ref_slot, ref_found = cuda_queue.pop_min_decision_ref(time_plane, tie)
        err = int((slot.to(torch.int64) - ref_slot.to(torch.int64)).abs().max())
        if err or not torch.equal(found, ref_found):
            raise SystemExit(f"pop_min kernel disagrees with its plain version on {name}")
        worst = max(worst, err)
        log(f"kernel == plain on {name}: slot and found exactly equal (tolerance 0) "
            f"(found {int(found.sum())}/{num_seeds})")
    time_plane, tie = cases[0][1:]
    tie32 = tie.to(torch.int32)
    s, q = time_plane.shape
    # the kernel alone: its C entry point with preallocated outputs
    slot = torch.empty((s,), dtype=torch.int32, device=dev)
    found = torch.empty((s,), dtype=torch.bool, device=dev)
    lib = cuda_queue.build()
    args = (time_plane.data_ptr(), tie32.data_ptr(), slot.data_ptr(), found.data_ptr(), s, q)

    def launch():
        rc = lib.madsim_pop_min(*args, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise SystemExit(f"pop_min kernel launch failed: CUDA error {rc}")

    def plain():
        cuda_queue.pop_min_decision_ref(time_plane, tie32)

    # device times with the host out of the loop (CUDA graphs); the
    # kernel's profiled duration and the host-paced launch rate beside them
    kernel_ms = graph_ms(launch, reps=200)
    plain_ms = graph_ms(plain, reps=20)
    profiled = profiled_kernel_ms(launch, reps=50, kernel="pop_min_kernel")
    kernel_host_ms = time_ms(launch, reps=200)
    plain_host_ms = time_ms(plain, reps=20)
    ref_slot, ref_found = cuda_queue.pop_min_decision_ref(time_plane, tie32)
    if not (torch.equal(slot, ref_slot) and torch.equal(found, ref_found)):
        raise SystemExit("pop_min kernel disagrees with its plain version after timing")
    log(f"pop_min at S={s} Q={q}: kernel {kernel_ms:.6f} ms (CUDA graph of 200 launches; "
        f"profiled duration {profiled} ms; host-paced {kernel_host_ms:.6f} ms), "
        f"plain {plain_ms:.6f} ms (CUDA graph; host-paced {plain_host_ms:.6f} ms)")
    return {"max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms,
            "profiled_ms": profiled}


def bound_ms(num_seeds: int, capacity: int):
    """Least time for one pop-min decision: bytes read and written over
    HBM bandwidth vs integer operations over the core rate."""
    bytes_moved = num_seeds * capacity * 8 + num_seeds * 4 + num_seeds * (4 + 1)
    ops = num_seeds * capacity * OPS_PER_SLOT
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_main_path(dev, num_seeds: int = NUM_SEEDS):
    """Drive the flagship sweep through the user entry point, counting
    step_batch calls and kernel launches over exactly this run."""
    import torch

    from madsim_tpu_torch.engine import core, cuda_queue
    from madsim_tpu_torch.models import raft

    wl, ecfg = flagship()
    seeds = torch.arange(num_seeds)
    calls = [0]
    step_batch = core.step_batch

    def counted(*args, **kwargs):
        calls[0] += 1
        return step_batch(*args, **kwargs)

    core.step_batch = counted
    try:
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        cuda_queue.pop_min_decision.launches = 0
        t0 = time.perf_counter()
        final = core.run_sweep(wl, ecfg, seeds, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cuda_queue.pop_min_decision.launches
    finally:
        core.step_batch = step_batch
    summary = raft.sweep_summary(final)
    log("flagship summary: " + json.dumps(summary, sort_keys=True))
    if not bool(final.done.all()):
        raise SystemExit("the flagship sweep hit max_steps before every seed finished")
    if summary["events_total"] <= 0 or summary["seeds"] != num_seeds:
        raise SystemExit("the flagship sweep did no work")
    per_seed = core.state_bytes_per_seed(wl, ecfg)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    log(f"main path: {num_seeds} seeds, {calls[0]} step_batch calls, "
        f"{launches} pop_min launches, wall {wall:.6f} s, "
        f"{num_seeds / wall:.3f} seeds/s, {summary['events_total'] / wall:.3f} events/s")
    log(f"loop state {per_seed} B/seed x {num_seeds} = {per_seed * num_seeds} B; "
        f"peak device memory {peak} B")
    if dev.type == "cuda" and launches != calls[0]:
        raise SystemExit(
            f"pop_min launches ({launches}) != step_batch calls ({calls[0]}): "
            "the main path did not go through the kernel on every event"
        )
    return final, launches


def phase_parity(final, golden_path: str) -> None:
    """Lanes 0-63 of the GPU run against the CPU port and the golden
    JAX-made summary."""
    from madsim_tpu_torch.engine import core, state_io, tree
    from madsim_tpu_torch.models import raft

    wl, ecfg = flagship()
    cpu = core.run_sweep(wl, ecfg, list(range(PARITY_SEEDS)), device="cpu")
    lanes = tree.map(lambda a: a[:PARITY_SEEDS], final)
    a, b = state_io.to_numpy_leaves(cpu), state_io.to_numpy_leaves(lanes)
    for i, (x, y) in enumerate(zip(a, b)):
        if x.dtype != y.dtype or x.shape != y.shape or not (x == y).all():
            raise SystemExit(f"GPU lanes 0-{PARITY_SEEDS - 1} differ from the CPU port at leaf {i}")
    log(f"cross-device parity: {len(a)} leaves of lanes 0-{PARITY_SEEDS - 1} equal the CPU port")
    with open(golden_path) as f:
        golden = json.load(f)
    got = raft.sweep_summary(final, limit=PARITY_SEEDS)
    if got != golden["summary"]:
        raise SystemExit(f"summary of lanes 0-63 {got} != golden {golden['summary']}")
    log("golden summary: GPU lanes 0-63 equal the JAX reference's summary")


def phase_replay(dev) -> None:
    from madsim_tpu_torch.engine import core, state_io

    wl, ecfg = flagship()
    g_final, g_trace = core.run_traced(wl, ecfg, REPLAY_SEED, device=dev)
    c_final, c_trace = core.run_traced(wl, ecfg, REPLAY_SEED, device="cpu")
    if sorted(g_trace) != sorted(c_trace):
        raise SystemExit("replay trace keys differ")
    for k in g_trace:
        if not bool((g_trace[k].cpu() == c_trace[k]).all()):
            raise SystemExit(f"replay trace {k!r} differs between the card and the CPU")
    for i, (x, y) in enumerate(zip(state_io.to_numpy_leaves(g_final),
                                   state_io.to_numpy_leaves(c_final))):
        if not (x == y).all():
            raise SystemExit(f"replay final state differs at leaf {i}")
    log(f"replay: seed {REPLAY_SEED}, {int(g_trace['fired'].sum())} events, "
        "card == CPU on every trace key and final leaf")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "madsim_tpu_torch")):
        print("chip_smoke: run from a checkout that holds madsim_tpu_torch/", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from madsim_tpu_torch.engine import cuda_queue

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    cuda_queue.build()
    log(f"built pop_min in {time.perf_counter() - t0:.3f} s")
    log(cuda_queue._Build.log.strip())

    k = phase_kernel(dev)
    final, launches = phase_main_path(dev)
    phase_parity(final, os.path.join(HERE, "madsim_tpu_torch", "data", "flagship_summary.json"))
    phase_replay(dev)

    b_ms, b_by = bound_ms(NUM_SEEDS, CAPACITY)
    kernels = [{
        "name": "pop_min",
        "route": "cuda",
        "source": "madsim_tpu_torch/csrc/pop_min.cu",
        "replaces": "madsim_tpu/engine/pallas_queue.py:54",
        "launches": launches,
        "equal": True,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "kernel_ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "profiled_ms": k["profiled_ms"],
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
