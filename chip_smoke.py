#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``madsim_tpu_torch``) on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs a CUDA card and the repository's ``madsim_tpu_torch`` package;
without either it exits non-zero and prints no result. It imports
neither JAX nor ``madsim_tpu``.

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device and build: the card's name and power limit, then both kernels
   built from ``madsim_tpu_torch/csrc/pop_min.cu`` and ``megasweep.cu``
   with nvcc, the two builds started together;
2. the kernel against its plain torch version on the card, at the main
   path's shape (16,384 seeds x 64 slots): flagship queues after 300
   events (real ties), empty queues and full queues with heavy ties —
   slot and found must be exactly equal; the kernel's and the plain
   version's device times from CUDA graphs of back-to-back calls timed
   by CUDA events, with the host-paced times printed beside them;
3. the main path: the MadRaft flagship (``RaftConfig(num_nodes=5,
   crashes=1)``, queue 64, 3 s horizon, 200,000 max steps) over 16,384
   seeds through ``core.run_sweep(..., device="cuda")``. The kernel's
   launch count is zeroed just before and must equal the number of
   ``step_batch`` calls just after;
4. cross-device parity: seeds 0-63 through the port on the CPU equal
   lanes 0-63 of the GPU state leaf for leaf, and the GPU run's
   ``sweep_summary(limit=64)`` equals the JAX-made golden summary
   ``madsim_tpu_torch/data/flagship_summary.json``;
5. replay: ``run_traced`` of one seed on the card equals the CPU replay;
6. the megasweep kernel against its plain version (``run_megasweep_ref``)
   on the card: the flagship-shaped probe (16,384 seeds x 512 steps,
   through ``run_megasweep``, its launch count zeroed just before and
   read just after), then the reference test's shapes (40 steps x 16
   seeds, tile 8; 17 x 16, tile 4) and the time-limit case (60 steps, 8
   seeds, limit 120 ms, where some seed must end done), and three edited
   probe states at 40 x 16 (``PROBE_STATES``: payload nodes whose ring
   cell wraps in int32, tied deadlines, empty queues) — every leaf
   exactly equal, one launch per call; the work the events needed,
   counted on the plain path (``run_megasweep_counted``: events, taken
   events, tied pops, live-slot visits), and from it the bound; the
   kernel's device time per call from a CUDA graph of back-to-back
   launches timed by CUDA events, and the plain version's time;
7. the A/B at 16,384 seeds through ``bench_megakernel.bench_batch``;
8. the spec-as-data raft path: the flagship with its fault spec replaced
   by a ``FaultEnvelope`` over two candidates (the flagship's spec and
   ``FaultSpec(crashes=2, partitions=1)``) and its per-kind event counter
   on, ``grid_params`` over 2 x 8,192 lanes at the 3 s horizon through
   ``core.run_sweep(..., params=..., device="cuda")``: fault events fire
   for both candidates, pop_min launches equal the ``step_batch`` calls,
   and lanes 0-31 of each candidate equal the CPU port on every leaf.

After the phases, both kernels' ``torch.profiler`` durations, from one
profiler session, are printed beside their CUDA-graph times. The line
before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

NUM_SEEDS = 16_384
CAPACITY = 64
HORIZON_NS = 3_000_000_000
MAX_STEPS = 200_000
PARITY_SEEDS = 64
REPLAY_SEED = 5
# H100 SXM: HBM bandwidth from the data sheet, and the issue ceiling for
# the kernels' 32-bit integer instructions (hashes, draws, compares). Each
# of an SM's 4 schedulers issues one warp-instruction per clock, whichever
# pipe takes it (the 64 INT32 lanes for IADD3/LOP3/SHF/ISETP, the FMA pipe
# for IMAD), so no instruction mix exceeds 132 SMs x 128 lanes x the SM
# clock: the data sheet's 1,980 MHz boost unless nvidia-smi reports the
# card's own. Operations below are counted as such instructions, two
# fused source operations (a 3-input add or logic op) counting once.
HBM_BYTES_PER_S = 3.35e12
SMS = 132
ISSUE_LANES_PER_SM = 128
SM_CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = SMS * ISSUE_LANES_PER_SM * SM_CLOCK_HZ
# integer operations per slot: the murmur finalizer (2 multiplies, 3
# shifts, 3 xors, the iota multiply and xor) and the 3-way compare/select
OPS_PER_SLOT = 14
# integer operations of the probe events of one megasweep call, counted
# from csrc/sim_math.cuh and probe_event.cuh for the work this run's
# events need (megakernel.run_megasweep_counted counts the events on the
# plain path), not the most they could: a threefry-2x32 block is 68
# instructions (20 rounds of add, rotate, xor; the key schedule's xors in
# one 3-input op; the counter's add; 5 injections into x1 of one 3-input
# add each, the injections into x0 folded into the next round's add but
# the last), a draw word one more (the xor of its block's two outputs).
# Per event: fold_in (68), w0, the clock jitter (69), and 40 for the
# clock, the masks, the counters and the occupancy; per live slot at the
# pop, 4 (its lowest set bit, the deadline's load, the compare and the
# select); per taken event, w2..w7, the handler's six draws (6 x 69; the
# handler's ring write, push and counters are in the 40); per event whose
# minimum deadline is tied, w1 (69), and per slot at that minimum 13 (the
# murmur priority, 9, since slot x 2654435761 is the same every event,
# and the (prio, slot) compare-select, 4). A unique minimum needs no
# priority, and an empty queue pops nothing.
OPS_THREEFRY_BLOCK = 68
OPS_DRAW_WORD = OPS_THREEFRY_BLOCK + 1
OPS_PER_EVENT = OPS_THREEFRY_BLOCK + OPS_DRAW_WORD + 40
OPS_PER_LIVE_VISIT = 4
OPS_PER_TAKEN_EVENT = 6 * OPS_DRAW_WORD
OPS_PER_TIED_EVENT = OPS_DRAW_WORD
OPS_PER_TIED_SLOT = 13

PROBE_SEEDS = 16_384
PROBE_STEPS = 512
# (steps, seeds, tile, time_limit): the reference's tests/test_megakernel.py
PROBE_CASES = ((40, 16, 8, 1 << 62), (17, 16, 4, 1 << 62), (60, 8, 8, 120_000_000))
GRID_LANES = 8_192
GRID_PARITY_LANES = 32


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


def profiled_kernels_ms(calls) -> dict:
    """Mean duration of each kernel in one ``torch.profiler`` trace:
    ``calls`` are ``(kernel name, fn, reps)``; each ``fn`` is called
    ``reps`` times and its kernel's device events averaged (None if the
    trace saw none). One session for all kernels: a second profiler
    session in one process recorded no device events on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _, fn, _ in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _, fn, reps in calls:
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    out = {}
    for kernel, _, _ in calls:
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        out[kernel] = (sum(e.time_range.elapsed_us() for e in events) / 1e3 / len(events)
                       if events else None)
    return out


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
    # host-paced launch rate beside them (main() adds the profiled time)
    kernel_ms = graph_ms(launch, reps=200)
    plain_ms = graph_ms(plain, reps=20)
    kernel_host_ms = time_ms(launch, reps=200)
    plain_host_ms = time_ms(plain, reps=20)
    ref_slot, ref_found = cuda_queue.pop_min_decision_ref(time_plane, tie32)
    if not (torch.equal(slot, ref_slot) and torch.equal(found, ref_found)):
        raise SystemExit("pop_min kernel disagrees with its plain version after timing")
    log(f"pop_min at S={s} Q={q}: kernel {kernel_ms:.6f} ms (CUDA graph of 200 launches; "
        f"host-paced {kernel_host_ms:.6f} ms), "
        f"plain {plain_ms:.6f} ms (CUDA graph; host-paced {plain_host_ms:.6f} ms)")
    return {"max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms, "launch": launch}


def _bound(bytes_moved: int, ops: int, int32_ops_per_s: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int32_ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(num_seeds: int, capacity: int, int32_ops_per_s: float = INT32_OPS_PER_S):
    """Least time for one pop-min decision: bytes read and written over
    HBM bandwidth vs integer operations over the issue ceiling."""
    bytes_moved = num_seeds * capacity * 8 + num_seeds * 4 + num_seeds * (4 + 1)
    return _bound(bytes_moved, num_seeds * capacity * OPS_PER_SLOT, int32_ops_per_s)


def megasweep_ops(counts) -> int:
    """The integer operations the events of one megasweep call needed,
    from their ``megakernel.MegasweepCounts``."""
    return (counts.events * OPS_PER_EVENT + counts.live_visits * OPS_PER_LIVE_VISIT
            + counts.taken * OPS_PER_TAKEN_EVENT + counts.tied * OPS_PER_TIED_EVENT
            + counts.tied_slots * OPS_PER_TIED_SLOT)


def megasweep_bound_ms(bytes_read: int, bytes_written: int, counts,
                       int32_ops_per_s: float = INT32_OPS_PER_S):
    """Least time for one megasweep call: its state read and written once
    over HBM bandwidth vs the integer operations its events needed (this
    run's counts) over the issue ceiling."""
    return _bound(bytes_read + bytes_written, megasweep_ops(counts), int32_ops_per_s)


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


def _leaves_equal(a, b, what: str) -> int:
    """Every leaf of two states exactly equal (value, dtype, shape), or
    exit; returns the number of leaves."""
    from madsim_tpu_torch.engine import state_io, tree

    bad = state_io.first_difference(a, b)
    if bad is not None:
        raise SystemExit(f"{what}: leaf {bad} differs")
    return len(tree.leaves(a))


def phase_parity(final, golden_path: str) -> None:
    """Lanes 0-63 of the GPU run against the CPU port and the golden
    JAX-made summary."""
    from madsim_tpu_torch.engine import core
    from madsim_tpu_torch.models import raft

    wl, ecfg = flagship()
    cpu = core.run_sweep(wl, ecfg, list(range(PARITY_SEEDS)), device="cpu")
    lanes = core.lane_slice(final, PARITY_SEEDS, 0)
    n = _leaves_equal(cpu, lanes, f"GPU lanes 0-{PARITY_SEEDS - 1} vs the CPU port")
    log(f"cross-device parity: {n} leaves of lanes 0-{PARITY_SEEDS - 1} equal the CPU port")
    with open(golden_path) as f:
        golden = json.load(f)
    got = raft.sweep_summary(final, limit=PARITY_SEEDS)
    if got != golden["summary"]:
        raise SystemExit(f"summary of lanes 0-63 {got} != golden {golden['summary']}")
    log("golden summary: GPU lanes 0-63 equal the JAX reference's summary")


def phase_replay(dev) -> None:
    from madsim_tpu_torch.engine import core

    wl, ecfg = flagship()
    g_final, g_trace = core.run_traced(wl, ecfg, REPLAY_SEED, device=dev)
    c_final, c_trace = core.run_traced(wl, ecfg, REPLAY_SEED, device="cpu")
    if sorted(g_trace) != sorted(c_trace):
        raise SystemExit("replay trace keys differ")
    for k in g_trace:
        if not bool((g_trace[k].cpu() == c_trace[k]).all()):
            raise SystemExit(f"replay trace {k!r} differs between the card and the CPU")
    _leaves_equal(g_final, c_final, "replay final state")
    log(f"replay: seed {REPLAY_SEED}, {int(g_trace['fired'].sum())} events, "
        "card == CPU on every trace key and final leaf")


def probe_state(dev, num_seeds: int, steps: int, time_limit: int = 1 << 62, edit=None):
    """The probe workload's initial state over seeds 0..num_seeds-1, its
    queue's deadlines and payloads changed in place by ``edit(time,
    pay)`` when given."""
    import torch

    from madsim_tpu_torch.engine import core, megakernel

    cfg = megakernel.probe_config(steps)._replace(time_limit_ns=time_limit)
    state = core.init_sweep(megakernel.probe_workload(), cfg, torch.arange(num_seeds),
                            device=dev)
    if edit is None:
        return state
    time, pay = state.queue.time.clone(), state.queue.pay.clone()
    edit(time, pay)
    return state._replace(queue=state.queue._replace(time=time, pay=pay))


def ring_row_fault(time, pay) -> None:
    """Payload word 0 outside [0, 5) in the three earliest live slots: the
    handler's ring cell node * 32 + idx wraps in int32 into rows 1, 3 and
    4 (a kernel that writes row ``node`` only for ``node`` in [0, 5)
    writes none)."""
    pay[:, 0, 0] = 2**27 + 1
    pay[:, 1, 0] = -(2**27) + 3
    pay[:, 2, 0] = 3 * 2**27 + 4


def tied_deadlines(time, pay) -> None:
    """Live slots sharing the minimum deadline: three at 3 ms, then two at
    5 ms, so the pop's murmur tie-break decides three events per seed."""
    time[:, 0:3] = 3_000_000
    time[:, 3:5] = 5_000_000


def empty_queue(time, pay) -> None:
    """Every other seed's queue empty: its first event finds nothing."""
    time[::2] = (1 << 63) - 1


# (name, edit) of the probe states beside the reference's shapes, each run
# at 40 steps x 16 seeds
PROBE_STATES = (("ring_row_fault", ring_row_fault), ("tied_deadlines", tied_deadlines),
                ("empty_queue", empty_queue))
PROBE_STATE_SHAPE = (40, 16)


def phase_megasweep(dev, num_seeds: int = PROBE_SEEDS, steps: int = PROBE_STEPS,
                    int32_ops_per_s: float = INT32_OPS_PER_S) -> dict:
    """The megasweep path and kernel against the plain version."""
    import torch

    from madsim_tpu_torch.engine import cuda_megasweep, megakernel

    s0 = probe_state(dev, num_seeds, steps)
    # the megasweep path: the user entry point at the flagship shape
    megakernel.run_megasweep.launches = 0
    got = megakernel.run_megasweep(s0, steps, tile=num_seeds)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = megakernel.run_megasweep.launches
    t0 = time.perf_counter()
    ref = megakernel.run_megasweep_ref(s0, steps)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n = _leaves_equal(ref, got, f"megasweep at {num_seeds} seeds x {steps} steps")
    log(f"megasweep == plain at {num_seeds} seeds x {steps} steps: {n} leaves exactly "
        f"equal (tolerance 0); {launches} kernel launches")
    # the work the bound counts: the same events again on the plain path
    counted, counts = megakernel.run_megasweep_counted(s0, steps)
    _leaves_equal(ref, counted, "the counting pass")
    cases = [(f"steps={c_steps} seeds={c_seeds} tile={tile} time_limit={limit}",
              probe_state(dev, c_seeds, c_steps, limit), c_steps, tile, limit)
             for c_steps, c_seeds, tile, limit in PROBE_CASES]
    c_steps, c_seeds = PROBE_STATE_SHAPE
    cases += [(f"{name} steps={c_steps} seeds={c_seeds}",
               probe_state(dev, c_seeds, c_steps, edit=edit), c_steps, c_seeds, 1 << 62)
              for name, edit in PROBE_STATES]
    for what, c0, c_steps, tile, limit in cases:
        before = megakernel.run_megasweep.launches
        c_got = megakernel.run_megasweep(c0, c_steps, limit, tile=tile)
        c_launches = megakernel.run_megasweep.launches - before
        c_ref = megakernel.run_megasweep_ref(c0, c_steps, limit)
        _leaves_equal(c_ref, c_got, f"megasweep case {what}")
        if dev.type == "cuda" and c_launches != 1:
            raise SystemExit(f"megasweep case {what}: {c_launches} launches, not 1")
        if limit < 1 << 62 and not bool(c_got.done.any()):
            raise SystemExit("time-limit case: no seed ended done")
        log(f"megasweep == plain at {what}: every leaf exactly equal "
            f"(done {int(c_got.done.sum())}/{c_got.done.shape[0]}, {c_launches} launches)")
    planes = cuda_megasweep.planes(s0)
    read = sum(t.numel() * t.element_size() for t in planes.values())
    written = read - planes["key"].numel() * planes["key"].element_size()
    b_ms, b_by = megasweep_bound_ms(read, written, counts, int32_ops_per_s)
    log(f"megasweep work at {num_seeds} seeds x {steps} steps (plain-path count): "
        f"{counts.events} events, {counts.taken} taken, {counts.tied} tied, "
        f"{counts.tied_slots} slots at tied minima, {counts.live_visits} live-slot visits")
    out = {"launches": launches, "equal": True, "max_abs_err": 0, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "counts": counts,
           "bytes": read + written, "ops": megasweep_ops(counts)}
    if dev.type != "cuda":
        return out

    # the kernel alone, on its own planes (each launch runs `steps` more
    # events of every seed: the probe never empties its queue, so each
    # launch does the work of the first, which the bound counts)
    def launch():
        cuda_megasweep.launch(planes, steps, 1 << 62)

    out["ms"] = graph_ms(launch, reps=10, rounds=3)
    out["launch"] = launch
    out["host_paced_ms"] = time_ms(lambda: megakernel.run_megasweep(s0, steps, tile=num_seeds),
                                   reps=5, rounds=3)
    log(f"megasweep at S={num_seeds} Q={s0.queue.time.shape[1]} steps={steps}: kernel "
        f"{out['ms']:.6f} ms per call (CUDA graph of 10 launches; "
        f"run_megasweep host-paced {out['host_paced_ms']:.6f} ms), plain {plain_ms:.6f} ms "
        f"per call (one call, host clock after synchronize); bound {b_ms:.6f} ms "
        f"({b_by}: {read + written} B, {out['ops']} int32 ops at {int32_ops_per_s:.6e}/s; "
        f"{out['ops'] / counts.events:.3f} per event)")
    return out


def phase_ab(num_seeds: int = PROBE_SEEDS) -> dict:
    from madsim_tpu_torch import bench_megakernel

    row = bench_megakernel.bench_batch(num_seeds)
    log(json.dumps(row))
    return row


def envelope_flagship():
    """The flagship with a FaultEnvelope over its own campaign and one
    more candidate, the per-kind event counter on; returns the workload,
    the engine config and the candidates' params."""
    from madsim_tpu_torch.engine import faults
    from madsim_tpu_torch.models import raft

    base = raft.RaftConfig(num_nodes=5, crashes=1)
    cands = (raft.fault_spec(base), faults.FaultSpec(crashes=2, partitions=1))
    env = faults.campaign_envelope(*cands)
    cfg = base._replace(faults=env, event_mix=True)
    ecfg = raft.engine_config(
        cfg, queue_capacity=CAPACITY, time_limit_ns=HORIZON_NS, max_steps=MAX_STEPS
    )
    params = [faults.spec_to_params(c, env, cfg.num_nodes) for c in cands]
    return raft.workload(cfg), ecfg, params


def phase_spec_as_data(dev, lanes: int = GRID_LANES, parity_lanes: int = GRID_PARITY_LANES):
    """The envelope grid on the device against the CPU port."""
    import numpy as np
    import torch

    from madsim_tpu_torch.engine import core, cuda_queue, faults
    from madsim_tpu_torch.models import raft

    wl, ecfg, params = envelope_flagship()
    k = len(params)
    seeds = np.tile(np.arange(lanes, dtype=np.int64), k)
    grid = faults.grid_params(params, lanes)
    calls = [0]
    step_batch = core.step_batch

    def counted(*args, **kwargs):
        calls[0] += 1
        return step_batch(*args, **kwargs)

    core.step_batch = counted
    try:
        cuda_queue.pop_min_decision.launches = 0
        t0 = time.perf_counter()
        final = core.run_sweep(wl, ecfg, seeds, device=dev, params=grid)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cuda_queue.pop_min_decision.launches
    finally:
        core.step_batch = step_batch
    if not bool(final.done.all()):
        raise SystemExit("the envelope sweep hit max_steps before every lane finished")
    if dev.type == "cuda" and launches != calls[0]:
        raise SystemExit(f"pop_min launches ({launches}) != step_batch calls ({calls[0]})")
    fired = final.evmix.to(torch.int64)[:, raft.K_FAULT]
    per_cand = [int(fired[i * lanes:(i + 1) * lanes].sum()) for i in range(k)]
    if min(per_cand) <= 0:
        raise SystemExit(f"fault events fired per candidate {per_cand}: some candidate fired none")
    log(f"spec-as-data: {k} candidates x {lanes} lanes, {calls[0]} step_batch calls, "
        f"{launches} pop_min launches, wall {wall:.6f} s; fault events fired per "
        f"candidate {per_cand}")
    cpu_seeds = np.tile(np.arange(parity_lanes, dtype=np.int64), k)
    cpu = core.run_sweep(wl, ecfg, cpu_seeds, device="cpu",
                         params=faults.grid_params(params, parity_lanes))
    for i in range(k):
        on_dev = core.lane_slice(final, parity_lanes, i * lanes)
        on_cpu = core.lane_slice(cpu, parity_lanes, i * parity_lanes)
        n = _leaves_equal(on_cpu, on_dev, f"candidate {i} lanes 0-{parity_lanes - 1}")
        summary = raft.sweep_summary(on_dev)
        if summary != raft.sweep_summary(on_cpu):
            raise SystemExit(f"candidate {i}: summary differs between the device and the CPU")
    log(f"spec-as-data parity: lanes 0-{parity_lanes - 1} of each candidate equal the CPU "
        f"port on all {n} leaves and the summary")
    return {"launches": launches, "steps": calls[0], "fired": per_cand}


def sm_clock_hz() -> float:
    """The card's maximum SM clock from nvidia-smi (the issue ceiling's clock)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "madsim_tpu_torch")):
        print("chip_smoke: run from a checkout that holds madsim_tpu_torch/", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from madsim_tpu_torch.engine import cuda_build, cuda_megasweep, cuda_queue

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    clock = sm_clock_hz()
    int32_rate = SMS * ISSUE_LANES_PER_SM * clock
    log(f"SM clock max {clock / 1e6:.0f} MHz: integer issue ceiling {int32_rate:.6e} ops/s")

    # both kernels built together, one nvcc each
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(cuda_queue.build), pool.submit(cuda_megasweep.build)]:
            job.result()
    log(f"built pop_min and megasweep in {time.perf_counter() - t0:.3f} s")
    for name in ("pop_min", "megasweep"):
        log(f"[{name}] " + cuda_build.LOGS.get(name, "(an identical build was loaded)").strip())

    k = phase_kernel(dev)
    final, launches = phase_main_path(dev)
    phase_parity(final, os.path.join(HERE, "madsim_tpu_torch", "data", "flagship_summary.json"))
    phase_replay(dev)
    mega = phase_megasweep(dev, int32_ops_per_s=int32_rate)
    phase_ab()
    phase_spec_as_data(dev)
    profiled = profiled_kernels_ms([("pop_min_kernel", k["launch"], 50),
                                    ("megasweep_kernel", mega["launch"], 5)])
    log(f"profiled kernel durations (one torch.profiler session): {json.dumps(profiled)} ms")

    b_ms, b_by = bound_ms(NUM_SEEDS, CAPACITY, int32_rate)
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
        "profiled_ms": profiled["pop_min_kernel"],
    }, {
        "name": "megasweep",
        "route": "cuda",
        "source": "madsim_tpu_torch/csrc/megasweep.cu",
        "replaces": "madsim_tpu/engine/megakernel.py:240",
        "launches": mega["launches"],
        "equal": True,
        "max_abs_err": mega["max_abs_err"],
        "ms": mega["ms"],
        "kernel_ms": mega["ms"],
        "plain_ms": mega["plain_ms"],
        "bound_ms": mega["bound_ms"],
        "bound_by": mega["bound_by"],
        "library_ms": None,
        "profiled_ms": profiled["megasweep_kernel"],
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
