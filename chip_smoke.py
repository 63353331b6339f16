#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``madsim_tpu_torch``) on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs a CUDA card and the repository's ``madsim_tpu_torch`` package;
without either it exits non-zero and prints no result. It imports
neither JAX nor ``madsim_tpu``.

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device and build: the host tier's compiled core
   (``madsim_tpu_torch/native/simcore.cpp`` with g++ and ``simloop.c``
   with gcc against the interpreter's ``Python.h``, into
   ``madsim_tpu_torch/_build/native/``), built when the package is
   imported: the script exits non-zero, naming ``native.build_error()``,
   if it did not build or load; then the card's name and power limit,
   then both kernels built from ``madsim_tpu_torch/csrc/pop_min.cu`` and
   ``megasweep.cu`` with nvcc, the two builds started together, and the
   core's build seconds beside nvcc's;
2. the kernel against its plain torch version on the card, at the main
   path's shape (16,384 seeds x 64 slots): flagship queues after 300
   events (real ties), empty queues and full queues with heavy ties —
   slot and found must be exactly equal; the kernel's and the plain
   version's device times from CUDA graphs of back-to-back calls timed
   by CUDA events, with the host-paced times printed beside them; then
   the same at phase 9's width (16,384 seeds x 48 slots: etcd queues
   after 100 events, empty queues, full queues with heavy ties);
3. the main path: the MadRaft flagship (``RaftConfig(num_nodes=5,
   crashes=1)``, queue 64, 3 s horizon, 200,000 max steps) over 16,384
   seeds through ``core.run_sweep(..., device="cuda")``. The kernel's
   launches over the run must equal its engine steps (``step_batch``
   calls and the steps ``core.drive``'s graph replayed), both counted by
   ``core.StepCount``;
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
   and lanes 0-31 of each candidate equal the CPU port on every leaf;
9. the checked etcd sweep (``EtcdConfig(hist_slots=256)``, queue 48, a
   2 s horizon): (a) 32,768 seeds as two chunks of 16,384 through
   ``oracle.screen.checked_sweep(..., workers=8, device="cuda")``, pop_min
   launches equal to the ``step_batch`` calls, the report equal to the
   JAX-made golden ``madsim_tpu_torch/data/etcd_checked_clean.json``,
   its wall time and seeds/s beside its unchecked twin's
   (``run_sweep_pipelined`` with no screen and no host work), the
   seconds of its chunk sweeps and of its host checking (the driver runs
   them one after the other) and the peak device memory; (c) lanes 0-63 of its first chunk equal the CPU
   port leaf for leaf, and ``screen_sweep`` and ``canon_sweep`` of that
   chunk equal the same functions on the CPU on all 16,384 lanes; (b)
   ``bug_stale_read`` over 2,048 seeds in chunks of 1,024 with
   ``device_decode`` on and off, each timed as (a) is: history violations
   found, both reports byte-equal to each other and to
   ``etcd_checked_stale.json``; (d) a
   1,024-seed state saved mid-run on the card with ``save_sweep(...,
   inflight=...)`` resumed through ``run_sweep_pipelined(resume_from=...)``
   on the CPU port and on the card to equal totals;
10. kafka (BASELINE.md #4): ``KafkaConfig()`` at its published widths
    (queue 48) at bench.py's 3 s horizon over 10,240 seeds through
    ``core.run_sweep(..., device="cuda")``: the summary equal to the
    JAX-made golden ``kafka_summary.json``, lanes 0-63 equal to the CPU
    port, and ``run_traced`` of a violating seed of the ack-on-append bug
    (two crashes) equal to the CPU replay;
11. S3: ``S3Config()`` at its engine defaults (5 s, queue 48) over 16,384
    seeds and the ack-before-durable bug over 2,048, both summaries equal
    to their goldens, the bug caught, lanes 0-63 equal to the CPU port;
12. the checked kafka sweep (``KafkaConfig(hist_slots=512)``, 2 s, 20,000
    steps): 10,240 seeds in two chunks of 5,120 and the ack-on-append bug
    over 2,048 in chunks of 1,024 through ``checked_sweep(...,
    workers=8)``, both reports equal to their goldens, the first chunk's
    log screen equal to the CPU's on every lane;
13. the stream (bench.py's streaming etcd config: stale-read bug,
    gray-failure faults, 3 s, 2,000 steps) over 16,384 seeds, pool and
    chunk 8,192: (a) ``stream_sweep`` twice against
    ``run_sweep_pipelined`` and the golden totals ``etcd_stream.json``,
    the second call inside ``compiles.count_compiles()`` counting 0 (in
    eager torch a kernel is built and loaded once per process, so this
    shows only that nothing was rebuilt);
    (b) ``checked_sweep`` with ``driver="stream"`` and ``"chunked"``,
    byte-equal reports equal to the golden; (c) a stream stopped after 2
    rounds and resumed on the card to the uninterrupted totals;
14. the seed mesh on the card (``madsim_tpu_torch.parallel``): phase 9's
    clean checked sweep (32,768 seeds) through ``checked_sweep(mesh=)`` at
    world size 1 (one rank, NCCL; 16,384 lanes per chunk) and 2 (two
    ranks sharing the card over gloo; 8,192 lanes per rank), each rank's
    report equal to ``etcd_checked_clean.json``; at world size 2 the
    flagship's seeds 0-63 through ``run_sweep_sharded``, equal to
    ``flagship_summary.json``; per world size the wall (the slowest
    rank's), seeds/s, events/s, each rank's peak device memory and
    pop_min launches against its ``step_batch`` calls;
15. the campaign on the card: ``entry.dryrun_multichip(2)`` (the sharded
    step, sweep and chunked composition against unsharded runs, and the
    amnesia gate's checked-sweep curve over 1 and 2 ranks at 2,048 seeds,
    each world size's report sha256 equal to the JAX reference's at as
    many devices, stored in ``campaign_amnesia.json``'s ``curves``)
    on a 2-rank world, then ``explore.sharded_campaign`` of
    ``amnesia_gate(smoke=False)`` at ``CampaignConfig(rounds=2,
    seeds_per_round=8192, chunk_size=4096)`` on 2 ranks, its JSONL
    report's sha256 equal to the JAX-made golden
    ``madsim_tpu_torch/data/campaign_amnesia.json``; rounds, seeds/s,
    events/s, violations, distinct failures and time to first bug;
16. the rest of explore on the card: (a) the steered campaign
    (``run_campaign(scheduler="bandit")``, bench.py's steering cell, raft
    arm, at 4,096 seeds per round and an 11,520,000-event budget, two
    violating seeds triaged per decision), its
    JSONL report's and decision trace's sha256 and its fingerprints
    equal to the JAX-made ``steer_raft.json``; decisions, kills,
    escalations, fingerprints, coverage bits, events to first bug, seeds
    and events swept and their rates, and the triage replays' count and
    seconds; (b) the fleet drill (``scripts/fleet_smoke.py``'s config
    over units 0-1): one ``run_worker`` and, beside it, two worker
    processes on the card with ``max_units=1`` into a second store, both
    merged reports equal to each other and to ``fleet_drill.json``, the
    shrinks' count, replays and seconds; and
    ``regression_gate`` over the JAX package's store of that drill
    (``data/fleet_store``); (c) ``run_differential(gate_specs())`` at
    ``DifferentialConfig()``, the host tier's outcomes computed live on
    the port's host runtime (800 host seeds, timed, each spec's equal to
    ``differential_host.json``), its report bytes equal to the JAX-made
    one, and ``device_outcomes_grid`` at 4,096 seeds per spec (16,384
    lanes) equal to ``differential_device.json``. Every run of phase 16
    replays seeds one lane at a time inside it (triage, shrink, the
    gate), so its launches are held to every engine step: the
    ``step_batch`` calls plus the replays' steps;
17. the cross-tier replay (``tests/test_replay.py``'s pipeline): (a)
    ``replay.amnesia_raft_config()`` (3-node volatile raft, 3 crashes,
    3 s, 30,000 steps) through ``core.run_sweep`` at 16,384 seeds,
    pop_min launches equal to the ``step_batch`` calls, the violating
    seeds among lanes 0-159 equal to the JAX-made
    ``madsim_tpu_torch/data/host_replay.json``; (b) ``run_traced`` of the
    second violating seed on the card, equal to the CPU's, its launches
    equal to its steps, and its fault plan equal to
    ``faults.compile_host`` and to the golden's; (c)
    ``replay.replay_on_host`` of that plan on the port's host runtime
    (the port's ``examples/raft_host.py``, host seeds 0-9), which must
    reproduce the violation with the golden's host seed, counters and
    history bytes. Each part's seconds and the host seeds per second are
    printed beside the card's name and power limit. Phases 16 (c) and 17
    (c) run the port's host tier on its compiled core
    (``native/simloop.c``), as the reference's runs by default;
18. the host tier on its compiled core: (a) ``differential.gate_specs()[0]``
    over ``DifferentialConfig()``'s 200 host seeds (2 s each) of the
    port's raft example, the fault plans compiled beforehand, in process
    on the core and again in a fresh interpreter under
    ``MADSIM_NO_NATIVE=1`` that imports no torch: both outcomes equal to
    ``differential_host.json``'s, and host seeds/s each way and their
    ratio; (b) ``rng.event_bits`` on the card of the flagship's 16,384
    seed keys at counters 0, 1, 7 and 123,456, 15 words each, equal word
    for word to ``native.fold_in`` + ``native.threefry2x32_batch`` on the
    host; (c) each shim program of ``tests/_torch_shim_programs.py``'s
    ``SMOKE`` (the greeter's four call kinds, kv_store's scenario, etcd,
    Kafka with a consumer group, S3 with a multipart upload, the tokio
    runtime) over seeds 0-63 on the core: the sha256 of the determinism
    logs and of the outputs, and every seed's draws and virtual ns, equal
    to the JAX package's ``host_shims.json``
    (``python tests/test_torch_shims_golden.py --write``); programs/s.
    Phase 18 launches no kernel;
19. the telemetry plane on the card and the real-mode twin: one
    ``obs.Telemetry`` (a journal, a Chrome trace and a ``/metrics``
    endpoint on a free localhost port) through (a) phase 9 (b)'s
    stale-read cell (2,048 seeds, chunks of 1,024) on
    ``checked_sweep(..., workers=8)``, its report equal to
    ``etcd_checked_stale.json``, as phase 9 (b)'s is, the endpoint scraped
    from a thread while it runs (the last scrape naming the chunk
    counters), its wall beside phase 9 (b)'s; (b) the same cell on
    ``driver="stream"`` (pool = chunk = 1,024), its report equal to (a)'s
    and ``stream_rounds_total`` equal to the driver's own rounds (its
    ``_round`` calls) and to the trace's occupancy samples; (c)
    ``RaftConfig(num_nodes=5, crashes=1, event_mix=True)``, queue 64, at
    16,384 seeds in one chunk and a 1 s horizon through
    ``run_sweep_pipelined``, its report (``event_mix`` included) equal to
    the JAX-made ``obs_event_mix.json``
    (``python tests/test_torch_obs_drivers.py --write``) and
    ``engine_events_by_kind_total{kind=k}`` equal to ``event_mix[k]``
    (phase 3 checks that the default report has no ``event_mix``); then,
    the handle closed, the trace has "device" and "host" tracks and
    chunk 1's device span (dispatch to summary) overlaps chunk 0's host
    check, and the journal holds one event per chunk and flush under one
    run ID; (d) on the chip machine's CPU over localhost, with no
    grpcio: the port's ``examples/greeter_real.py`` and one real-mode
    etcd, Kafka (the genuine wire on ``kafka.wire.WireServer``) and S3
    round trip and a ``kafka.probe.ProbeClient`` session against the
    port's ``WireServer`` (``tests/_torch_real_programs.py``'s
    ``SMOKE``), each run three times, every outcome's digest equal to
    the JAX package's ``real_outcomes.json``; runs and seconds;
20. the wire rig on the chip machine's CPU, needing neither grpcio nor
    aiohttp (nothing imports or probes for them), pop_min's launch count zeroed
    before and read as 0 after: (a) ``wire_load``'s determinism report
    (seeded sequential Kafka, S3 and framed etcd sessions on counter
    clocks) for seeds 0-1, both server kinds and telemetry on and off,
    each equal as bytes to the JAX-made ``wire_load_determinism.json``
    (``python tests/test_torch_wire_load.py --write``) with both
    replays ok; (b) ``kafka.fuzz``'s digests for seeds 0-49 on loopback
    and 1-5 over localhost TCP, equal to ``kafka_fuzz.json``
    (``python tests/test_torch_wire_differential.py --write``); (c) the
    smoke rig (``SMOKE_SCENARIO``: 64 clients in 2 worker processes for
    4 s) as a fresh subprocess, ``python -m madsim_tpu_torch.wire_load
    --smoke --report FILE`` (this process has CUDA and torch's threads
    and must not fork the workers): its gate and the async-vs-legacy
    parity must hold; clients, ops, ops/s, peak connections and each
    wire's p50/p99 are printed beside the card's name and power limit;
21. the command-line drivers (``madsim_tpu_torch/scripts``) on the card by
    their documented commands, against the JAX-made
    ``madsim_tpu_torch/data/scripts_golden.json``
    (``python tests/test_torch_scripts_golden.py --write``): (a)
    ``sweep_million 17384 CKPT --device cuda`` (the flagship in one full
    chunk of 16,384 and a ragged one of 1,000) through the module's
    ``main`` in this process, its ``step_batch`` calls (the warm-up's
    one step included) equal to pop_min's launches, every chunk file's
    summary equal to the reference's at that total, 0 kernel builds or
    loads in the timed region; then the same command as a fresh
    ``python -m`` process, which loads both chunks from the first run's
    checkpoints, computes none and prints the same totals; (b) the
    determinism gate's dump leg, ``python -m
    madsim_tpu_torch.scripts.check_determinism --legs dump --device
    cuda --jobs 2``: two fresh processes, side by side, write
    byte-identical archives, every array equal to the JAX package's dump
    by name, dtype, shape and sha256, each process's pop_min launches
    equal to its engine steps.

Phases 10-17 print their wall seconds, seeds/s, events/s and peak device
memory, and each counts pop_min's launches over every driven run and
checks they equal the engine steps (``core.StepCount``: the
``step_batch`` calls and the steps ``core.drive`` replayed as a CUDA
graph, and in 16-17 the one-lane replays' steps too); so does phase 19, phase 20 checks it
stays 0, and phase 21 holds it to the in-process sweep's steps and to
each dump process's own. Every phase's seconds are printed. After the
phases, both kernels' ``torch.profiler`` durations, from one profiler
session, are printed beside their CUDA-graph times. The line before the
last is ``{"kernels": [...]}`` (pop_min's launches summed over phases 3,
8-17 and 19-21 (0 in 20), in 14-15 over the ranks, in 16 over the
fleet's worker processes and in 21 over this process and the dump's
two; its Q = 48 times beside the Q = 64 ones); the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
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
# phase 9, the checked etcd sweep: bench.py's checked leg, EtcdConfig
# (hist_slots=256) at a 2 s horizon (queue 48). (seeds, chunk) of the
# card's runs, clean and stale-read, then of the CPU rehearsal's
ETCD_HIST_SLOTS = 256
ETCD_HORIZON_NS = 2_000_000_000
CLEAN_RUNS = ((32_768, 16_384), (48, 24))
STALE_RUNS = ((2_048, 1_024), (32, 16))
CHECK_WORKERS = 8
ETCD_PARITY_SEEDS = 64
# (seeds, steps on the card before the snapshot) of the cross-device resume
ETCD_CKPT = (1_024, 64)
# phase 10, kafka (BASELINE.md #4, bench.py's bench_secondary_models):
# KafkaConfig() at its published widths, queue 48, bench.py's 3 s
# SIM_SECONDS; seeds of the card's run and of the CPU rehearsal, and the
# replayed seed of the ack-on-append bug (it violates)
KAFKA_HORIZON_NS = 3_000_000_000
KAFKA_RUNS = (10_240, 64)
KAFKA_BUG = {"bug_ack_on_append": True, "crashes": 2}
KAFKA_REPLAY_SEED = 2
# phase 11, S3 at its published widths and engine defaults (5 s, queue
# 48): seeds of the clean and the ack-before-durable runs, card then CPU
S3_RUNS = (16_384, 64)
S3_BUG = {"bug_ack_before_durable": True}
S3_BUG_RUNS = (2_048, 48)
S3_REPLAY_SEED = 12
# phase 12, the checked kafka sweep: tests/test_oracle.py's "no false
# positives" config, KafkaConfig(hist_slots=512) at 2 s and 20,000 steps;
# (seeds, chunk) of the card's runs and of the CPU rehearsal's
KAFKA_HIST_SLOTS = 512
KAFKA_CHECKED_ENGINE = {"time_limit_ns": 2_000_000_000, "max_steps": 20_000}
KAFKA_CLEAN_RUNS = ((10_240, 5_120), (48, 24))
KAFKA_BUG_RUNS = ((2_048, 1_024), (32, 16))
# phase 13, the stream: bench.py's bench_streaming etcd config (stale-read
# bug, gray-failure spec, 3 s, 2,000 steps) at a STREAM_CURVE point; the
# card's pool and chunk sizes (not the reference's TPU constants, 512 and
# 1,024: an eager step costs the same at 1,024 lanes as at 16,384), then
# the CPU rehearsal's
STREAM_ENGINE = {"time_limit_ns": 3_000_000_000, "max_steps": 2_000}
STREAM_RUNS = ((16_384, 8_192), (32, 16))
STREAM_POOL = (8_192, 16)
STREAM_ROUND_STEPS = 256
# phase 14, the mesh on one card: phase 9's clean checked etcd sweep at
# world sizes 1 (NCCL) and 2 (two ranks sharing the card over gloo), the
# same global chunk at both (so the report is phase 9's golden); (seeds,
# global chunk) of the card's run, then of the CPU rehearsal's (two gloo
# ranks); and the flagship's seeds 0-63 sharded over 2 ranks
MESH_WORLDS = (1, 2)
MESH_RUNS = (CLEAN_RUNS[0], CLEAN_RUNS[1])
MESH_FLAGSHIP_SEEDS = PARITY_SEEDS
# phase 15, the campaign: dryrun_multichip(2)'s checked-sweep curve
# (seeds, per-rank chunk, warm-up seeds: None is one chunk, which loads
# the kernels untimed; the CPU has nothing to warm) on the card and on
# the CPU, and the amnesia gate's campaign (amnesia_gate(smoke=False))
# on 2 ranks: (rounds, seeds_per_round, chunk_size) of the card's run,
# then the rehearsal's. The card's run is cut from 4 rounds to 2: 4 took
# 127 s on 2 ranks, and phases 14-15 are held to about 3 minutes
CURVE_RUNS = ((2_048, 1_024, None), (64, 32, 0))
CAMPAIGN_RUNS = ((2, 8_192, 4_096), (2, 32, 32))
CAMPAIGN_WORLD = 2
# phase 16 (a), the steered campaign: bench.py's steering cell, raft arm
# (bench.py:122-138, :942-957), its families, escalation, kill rule and
# campaign seed; (seeds per round, event budget, recorded seeds per
# decision) of the card's run — the cell's seed granule (16) and event
# budget (45,000) both scaled x256 — then of the CPU rehearsal's. The
# cell records 8 violating seeds a decision; each is triaged by a
# one-lane replay, 4.97 s apiece on the card (32 replays took 159 s of
# the campaign's 235 s), so the card's run records 2
STEER_FAMILIES = (0x001, 0x002, 0x003, 0x004, 0x008,
                  0x010, 0x020, 0x040, 0x080, 0x100)
STEER_ESCALATE_SEEDS = 8
STEER_KILL_PLAYS = 1
STEER_CAMPAIGN_SEED = 7
STEER_RUNS = ((4_096, 11_520_000, 2), (16, 6_000, 2))
STEER_GOLDEN = "steer_raft.json"
# phase 16 (b), the fleet drill: scripts/fleet_smoke.py's pinned config
# (:46-53) over units 0-1 of its 4-unit plan, which reach fingerprint n0
# only; (seeds per round = chunk, recorded seeds, shrink replays) of the
# card's run, then of the rehearsal's. The regression gate replays the
# JAX package's store of the card's drill, kept under data/
FLEET_UNITS = 2
FLEET_TARGET = {"time_limit_ns": 1_500_000_000, "max_steps": 15_000, "hist_slots": 0}
FLEET_BASE = {"crashes": 3, "crash_window_ns": 1_200_000_000,
              "restart_lo_ns": 50_000_000, "restart_hi_ns": 300_000_000}
FLEET_CAMPAIGN = {"batch": 2, "campaign_seed": 7}
FLEET_RUNS = ((24, 4, 24), (8, 1, 2))
FLEET_GOLDEN = "fleet_drill.json"
FLEET_STORE = "fleet_store"
# phase 16 (c), the differential: run_differential over gate_specs() at
# DifferentialConfig(seeds, sim_seconds) (the card's run is the config's
# defaults, the host tier's outcomes computed live on the port's host
# runtime and held to differential_host.json), then the device grid alone
# at card width; card, then rehearsal
DIFF_RUNS = ((200, 2.0), (16, 1.0))
DIFF_GRID_RUNS = ((4_096, 2.0), (16, 1.0))
DIFF_GOLDEN = "differential_device.json"
DIFF_HOST_GOLDEN = "differential_host.json"
# phase 17, the cross-tier replay: tests/test_replay.py's pipeline on
# replay.amnesia_raft_config() (3-node volatile raft, 3 crashes, 3 s,
# 30,000 steps) at card width; the golden holds the reference test's
# lanes 0-159, its second violating seed, that seed's plan and the host
# tier's reproduction over host seeds 0-9; card, then rehearsal
REPLAY_RUNS = (16_384, 64)
REPLAY_GOLDEN_LANES = 160
REPLAY_HOST_SEEDS = 10
REPLAY_SIM_SECONDS = 3.0
REPLAY_GOLDEN = "host_replay.json"
# phase 18, the host tier on its compiled core: (a) gate_specs()[0] over
# phase 16 (c)'s host seeds (DifferentialConfig()'s 200 at 2 s on the card,
# the rehearsal's 16 at 1 s), on the core and in a fresh interpreter under
# MADSIM_NO_NATIVE=1, against differential_host.json; (b) the device draw
# stream, rng.event_bits of the flagship's seed keys at NATIVE_CTRS, 15
# words each, against native.fold_in + threefry2x32_batch (lanes: card,
# then rehearsal); (c) each program of tests/_torch_shim_programs.py's
# SMOKE over seeds 0..n-1 against host_shims.json (card, then rehearsal)
NATIVE_HOST_RUNS = DIFF_RUNS
NATIVE_DRAW_LANES = (16_384, 64)
NATIVE_CTRS = (0, 1, 7, 123_456)
NATIVE_DRAW_WORDS = 15
SHIM_RUNS = (64, 8)
SHIMS_GOLDEN = "host_shims.json"
# phase 19: the telemetry plane on the card, over phase 9 (b)'s stale-read
# cell (both drivers) and the flagship raft config with the device-side
# event-mix plane on, its horizon cut from phase 3's 3 s to 1 s (the card
# size, then the rehearsal size of its JAX-made golden); then the
# real-mode programs of tests/_torch_real_programs.py, each run this many
# times, against the JAX package's outcome digests
EVENT_MIX_RUNS = ({"seeds": 16_384, "chunk": 16_384, "time_limit_ns": 1_000_000_000},
                  {"seeds": 64, "chunk": 32, "time_limit_ns": 300_000_000})
EVENT_MIX_GOLDEN = "obs_event_mix.json"
REAL_REPS = (3, 1)
REAL_GOLDEN = "real_outcomes.json"
# phase 20: the wire rig on the chip machine's CPU; (a) the determinism
# reports' seeds, against the JAX-made golden, (b) the Kafka fuzz's
# golden (its seeds and ops), (c) the smoke rig's subprocess time limit
# (the rig itself runs 4 s and about 10 s in all)
WIRE_DET_SEEDS = (0, 1)
WIRE_DET_GOLDEN = "wire_load_determinism.json"
FUZZ_GOLDEN = "kafka_fuzz.json"
WIRE_SMOKE_TIMEOUT_S = 180
# phase 21: the command-line drivers on the card; (a) sweep_million's
# (total, chunk) at the card's size (one full flagship chunk and a ragged
# one) and the CPU rehearsal's, each against the JAX-made golden
# ``scripts_golden.json``; (b) the gate's dump leg in fresh processes
SCRIPT_SWEEP_RUNS = ((17_384, 16_384), (24, 16))
SCRIPTS_GOLDEN = "scripts_golden.json"
SCRIPT_TIMEOUT_S = 900


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


def main_path_run(dev, fn):
    """Run ``fn()`` as a driven main path (``engine_steps_run``); returns
    ``(result, step_batch calls, launches, wall s)``."""
    r = engine_steps_run(dev, fn)
    return r["out"], r["calls"], r["launches"], r["wall"]


def engine_steps_run(dev, fn) -> dict:
    """Run ``fn()`` as a driven path, its engine steps and pop_min's
    launches counted by ``core.StepCount``: the batched steps
    (``step_batch`` calls and the steps ``core.drive``'s step graphs
    replayed) and the steps of one-lane replays (``core.run_traced``
    steps the engine without ``step_batch``) apart. On the card every
    step must have launched the kernel once."""
    import torch

    from madsim_tpu_torch.engine import core

    with core.StepCount() as count:
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if dev.type == "cuda" and count.launches != count.steps:
        raise SystemExit(
            f"pop_min launches ({count.launches}) != engine steps ({count.steps}: "
            f"{count.batched} batched and the one-lane replays' steps): the path did not go "
            "through the kernel on every event")
    return {"out": out, "calls": count.batched, "replay_steps": count.steps - count.batched,
            "launches": count.launches, "captures": count.captures, "wall": wall,
            "peak": _peak(dev)}


def flagship():
    from madsim_tpu_torch.models import raft

    cfg = raft.RaftConfig(num_nodes=5, crashes=1)
    ecfg = raft.engine_config(
        cfg, queue_capacity=CAPACITY, time_limit_ns=HORIZON_NS, max_steps=MAX_STEPS
    )
    return raft.workload(cfg), ecfg


def etcd_path(stale: bool = False):
    """Phase 9's etcd history workload and engine config (queue 48)."""
    from madsim_tpu_torch.models import etcd

    cfg = etcd.EtcdConfig(**etcd_fields(stale))
    return etcd.workload(cfg), etcd.engine_config(cfg, time_limit_ns=ETCD_HORIZON_NS)


def kernel_cases(dev, num_seeds: int, etcd_queue: bool = False):
    """(name, time [S, Q], tie [S]) inputs at a path's shape: the
    flagship's queues after 300 events (Q = 64), or phase 9's etcd
    queues after 100 events (Q = 48), then empty and full queues with
    heavy ties at the same width."""
    import torch

    from madsim_tpu_torch.engine import core, cuda_queue, rng

    wl, ecfg = etcd_path() if etcd_queue else flagship()
    steps = 100 if etcd_queue else 300
    cap = ecfg.queue_capacity
    state = core.init_sweep(wl, ecfg, torch.arange(num_seeds), device=dev)
    for _ in range(steps):
        state = core.step_batch(wl, ecfg, state, device=dev)
    # the tie-break draw the next event would use
    tie = rng.event_bits(state.key, state.ctr, wl.num_rand + 2)[:, 1]
    words = rng.bits(rng.seed_key(torch.arange(num_seeds, device=dev) + 99), 3)
    heavy = (words[:, :1] + torch.arange(cap, device=dev)) % 3  # 3-way ties
    inv = cuda_queue.INVALID_TIME
    path = "etcd" if etcd_queue else "flagship"
    return [
        (f"{path}_after_{steps}_events", state.queue.time.contiguous(), tie),
        (f"empty_q{cap}", torch.full((num_seeds, cap), inv, dtype=torch.int64, device=dev),
         words[:, 1]),
        (f"full_heavy_ties_q{cap}", heavy.contiguous(), words[:, 2]),
    ]


def phase_kernel(dev, num_seeds: int = NUM_SEEDS, etcd_queue: bool = False) -> dict:
    """The kernel against its plain version on the same inputs, at the
    flagship's queue width or at phase 9's (``etcd_queue``)."""
    import torch

    from madsim_tpu_torch.engine import cuda_queue

    worst = 0
    cases = kernel_cases(dev, num_seeds, etcd_queue)
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
    # the launch holds the tensors, not just their addresses: main() calls
    # it again after later phases, by when memory freed here may have been
    # given back to the driver
    planes = (time_plane, tie32, slot, found)

    def launch():
        args = [t.data_ptr() for t in planes] + [s, q]
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
    return {"max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms, "launch": launch,
            "capacity": q}


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

    from madsim_tpu_torch.engine import core
    from madsim_tpu_torch.models import raft

    wl, ecfg = flagship()
    seeds = torch.arange(num_seeds)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    final, calls, launches, wall = main_path_run(
        dev, lambda: core.run_sweep(wl, ecfg, seeds, device=dev))
    summary = raft.sweep_summary(final)
    log("flagship summary: " + json.dumps(summary, sort_keys=True))
    if "event_mix" in summary:
        raise SystemExit("the default flagship report carries the opt-in event_mix plane")
    if not bool(final.done.all()):
        raise SystemExit("the flagship sweep hit max_steps before every seed finished")
    if summary["events_total"] <= 0 or summary["seeds"] != num_seeds:
        raise SystemExit("the flagship sweep did no work")
    per_seed = core.state_bytes_per_seed(wl, ecfg)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    log(f"main path: {num_seeds} seeds, {calls} step_batch calls, "
        f"{launches} pop_min launches, wall {wall:.6f} s, "
        f"{num_seeds / wall:.3f} seeds/s, {summary['events_total'] / wall:.3f} events/s")
    log(f"loop state {per_seed} B/seed x {num_seeds} = {per_seed * num_seeds} B; "
        f"peak device memory {peak} B")
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

    from madsim_tpu_torch.engine import core, faults
    from madsim_tpu_torch.models import raft

    wl, ecfg, params = envelope_flagship()
    k = len(params)
    seeds = np.tile(np.arange(lanes, dtype=np.int64), k)
    grid = faults.grid_params(params, lanes)
    final, calls, launches, wall = main_path_run(
        dev, lambda: core.run_sweep(wl, ecfg, seeds, device=dev, params=grid))
    if not bool(final.done.all()):
        raise SystemExit("the envelope sweep hit max_steps before every lane finished")
    fired = final.evmix.to(torch.int64)[:, raft.K_FAULT]
    per_cand = [int(fired[i * lanes:(i + 1) * lanes].sum()) for i in range(k)]
    if min(per_cand) <= 0:
        raise SystemExit(f"fault events fired per candidate {per_cand}: some candidate fired none")
    log(f"spec-as-data: {k} candidates x {lanes} lanes, {calls} step_batch calls, "
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
    return {"launches": launches, "steps": calls, "fired": per_cand}


def etcd_fields(stale: bool) -> dict:
    """The ``EtcdConfig`` fields of phase 9's clean or stale-read runs."""
    return {"hist_slots": ETCD_HIST_SLOTS, "bug_stale_read": stale}


def kafka_fields(bug: bool = False, hist_slots: int = 0) -> dict:
    """The ``KafkaConfig`` fields of phase 10 (``hist_slots=0``) or 12."""
    out = dict(KAFKA_BUG) if bug else {}
    if hist_slots:
        out["hist_slots"] = hist_slots
    return out


def kafka_path(bug: bool = False):
    """Phase 10's kafka workload and engine config (queue 48)."""
    from madsim_tpu_torch.models import kafka

    cfg = kafka.KafkaConfig(**kafka_fields(bug))
    return kafka.workload(cfg), kafka.engine_config(cfg, time_limit_ns=KAFKA_HORIZON_NS)


def kafka_checked_path(bug: bool = False):
    """Phase 12's kafka history workload and engine config."""
    from madsim_tpu_torch.models import kafka

    cfg = kafka.KafkaConfig(**kafka_fields(bug, KAFKA_HIST_SLOTS))
    return kafka.workload(cfg), kafka.engine_config(cfg, **KAFKA_CHECKED_ENGINE)


def s3_path(bug: bool = False):
    """Phase 11's S3 workload and engine config (its defaults)."""
    from madsim_tpu_torch.models import s3

    cfg = s3.S3Config(**(S3_BUG if bug else {}))
    return s3.workload(cfg), s3.engine_config(cfg)


STREAM_FAULTS = {"crashes": 2, "partitions": 2, "spikes": 1, "losses": 1, "pauses": 1}


def stream_path():
    """Phase 13's etcd workload: bench_streaming's config."""
    from madsim_tpu_torch.engine import faults
    from madsim_tpu_torch.models import etcd

    cfg = etcd.EtcdConfig(hist_slots=64, bug_stale_read=True,
                          faults=faults.FaultSpec(**STREAM_FAULTS))
    return etcd.workload(cfg), etcd.engine_config(cfg, **STREAM_ENGINE)


def data_path(name: str) -> str:
    return os.path.join(HERE, "madsim_tpu_torch", "data", name)


def load_golden(name: str) -> dict:
    with open(data_path(name)) as f:
        return json.load(f)


# phase 15's golden: the JAX package's campaign report of the amnesia gate
CAMPAIGN_GOLDEN = "campaign_amnesia.json"


def campaign_golden_config() -> dict:
    """What phase 15's golden reports were made from."""
    return {"target": "explore.targets.amnesia_gate(smoke=False)", "world": "unsharded"}


def campaign_key(rounds: int, seeds_per_round: int, chunk_size: int) -> str:
    return f"rounds={rounds} seeds_per_round={seeds_per_round} chunk_size={chunk_size}"


def curve_key(seeds: int, chunk_per_device: int) -> str:
    return f"seeds={seeds} chunk_per_device={chunk_per_device}"


# golden file -> the config it was made from (the JAX package's model and
# engine fields; faults as FaultSpec fields)
GOLDEN_CONFIGS = {
    "kafka_summary.json": {"kafka": kafka_fields(), "engine": {"time_limit_ns": KAFKA_HORIZON_NS}},
    "s3_summary.json": {"s3": {}, "engine": {}},
    "s3_bug_summary.json": {"s3": S3_BUG, "engine": {}},
    "kafka_checked_clean.json": {"kafka": kafka_fields(False, KAFKA_HIST_SLOTS),
                                 "engine": KAFKA_CHECKED_ENGINE},
    "kafka_checked_bug.json": {"kafka": kafka_fields(True, KAFKA_HIST_SLOTS),
                               "engine": KAFKA_CHECKED_ENGINE},
    "etcd_stream.json": {"etcd": {"hist_slots": 64, "bug_stale_read": True},
                         "faults": STREAM_FAULTS, "engine": STREAM_ENGINE},
}


def golden_path(stale: bool) -> str:
    name = "etcd_checked_stale.json" if stale else "etcd_checked_clean.json"
    return os.path.join(HERE, "madsim_tpu_torch", "data", name)


def golden_config(stale: bool) -> dict:
    return {"etcd": etcd_fields(stale), "engine": {"time_limit_ns": ETCD_HORIZON_NS}}


def golden_runs(stale: bool):
    """(seeds, chunk) of the card's run and of the CPU rehearsal's."""
    return STALE_RUNS if stale else CLEAN_RUNS


def run_key(seeds: int, chunk: int) -> str:
    return f"seeds={seeds} chunk={chunk}"


def _same_report(got: dict, want: dict, what: str) -> None:
    if json.dumps(got, sort_keys=True) != json.dumps(want, sort_keys=True):
        raise SystemExit(f"{what}: report {json.dumps(got, sort_keys=True)} != "
                         f"{json.dumps(want, sort_keys=True)}")


class PhaseClock:
    """Seconds of a checked sweep's two phases, summed over its chunks:
    ``sweep_seconds`` of the chunks' sweeps (``core.run_sweep`` while
    ``timing`` patches it; each returns when the card has finished) and,
    as a duck-typed ``telemetry`` handle, the host work's
    ``oracle_check_seconds`` (decode, dedup, WGL). It records no report
    byte."""

    tracer = None

    def __init__(self):
        self.seconds: dict = {}

    @contextlib.contextmanager
    def timing(self, keep=None):
        """Patch ``core.run_sweep`` to time each chunk's sweep, and keep
        the first chunk's final state in the list ``keep``."""
        from madsim_tpu_torch.engine import core

        run_sweep = core.run_sweep

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = run_sweep(*args, **kwargs)
            self.observe("sweep_seconds", time.perf_counter() - t0)
            if keep is not None and not keep:
                keep.append(out)
            return out

        core.run_sweep = timed
        try:
            yield self
        finally:
            core.run_sweep = run_sweep

    def observe(self, name, value, help=None):
        self.seconds[name] = self.seconds.get(name, 0.0) + value

    def count(self, *args, **kwargs):
        pass

    gauge = event = event_mix = sample = count

    def split(self) -> str:
        sweep_s = self.seconds.get("sweep_seconds", 0.0)
        host_s = self.seconds.get("oracle_check_seconds", 0.0)
        return f"chunk sweeps {sweep_s:.6f} s, host checking {host_s:.6f} s"


def phase_checked_sweep(dev, clean=CLEAN_RUNS[0], stale=STALE_RUNS[0],
                        workers: int = CHECK_WORKERS, parity_seeds: int = ETCD_PARITY_SEEDS,
                        ckpt=ETCD_CKPT) -> dict:
    """The checked etcd sweep (phase 9): (a) the clean sweep through
    ``oracle.screen.checked_sweep`` against the golden report, timed with
    its unchecked twin; (c) lanes 0-63 of its first chunk against the
    CPU port, and the screen and canonical decode of that chunk against
    the same functions on the CPU; (b) the stale-read bug through both
    decode routes against its golden; (d) a snapshot taken mid-run on the
    device resumed on the CPU and on the device."""
    import numpy as np
    import torch

    from madsim_tpu_torch.engine import checkpoint, core, tree
    from madsim_tpu_torch.models import etcd
    from madsim_tpu_torch.oracle import check, history, screen

    spec = etcd.history_spec()
    cuda = dev.type == "cuda"
    launches = steps = 0

    def goldens(stale_bug: bool) -> dict:
        with open(golden_path(stale_bug)) as f:
            return json.load(f)["reports"]

    # (a) the clean checked sweep, its first chunk kept for (c)
    wl, ecfg = etcd_path()
    n, chunk = clean
    seeds = np.arange(n, dtype=np.int64)
    firsts = []
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    clock = PhaseClock()
    with clock.timing(keep=firsts):
        report, calls, got, wall = main_path_run(dev, lambda: screen.checked_sweep(
            wl, ecfg, seeds, spec, etcd.sweep_summary, chunk_size=chunk,
            workers=workers, device=dev, telemetry=clock))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    launches, steps = launches + got, steps + calls
    log("checked etcd sweep: " + json.dumps(report, sort_keys=True))
    _same_report(report, goldens(False)[run_key(n, chunk)], "clean checked sweep vs golden")
    _, u_calls, u_got, u_wall = main_path_run(dev, lambda: checkpoint.run_sweep_pipelined(
        wl, ecfg, seeds, etcd.sweep_summary, chunk_size=chunk, device=dev))
    launches, steps = launches + u_got, steps + u_calls
    log(f"checked sweep: {n} seeds in {n // chunk} chunks of {chunk}, {calls} step_batch "
        f"calls, {got} pop_min launches, wall {wall:.6f} s, {n / wall:.3f} seeds/s; "
        f"unchecked twin {u_wall:.6f} s, {n / u_wall:.3f} seeds/s; checked/unchecked "
        f"{wall / u_wall:.6f}; {clock.split()}; {report['hist_suspects']} suspects, "
        f"{report['hist_violations']} history violations; peak device memory {peak} B; "
        f"loop state {core.state_bytes_per_seed(wl, ecfg)} B/seed, queue "
        f"{ecfg.queue_capacity}")
    out = {"seeds": n, "chunk": chunk, "wall_s": wall, "unchecked_wall_s": u_wall,
           "peak_bytes": peak, "report": report, "phases_s": clock.seconds}

    # (c) cross-device parity on the first chunk
    first = firsts[0]
    on_cpu = core.run_sweep(wl, ecfg, list(range(parity_seeds)), device="cpu")
    k = _leaves_equal(on_cpu, core.lane_slice(first, parity_seeds, 0),
                      f"etcd lanes 0-{parity_seeds - 1} vs the CPU port")
    copy = tree.map(lambda a: a.cpu(), first)
    s_dev, s_cpu = screen.screen_sweep(first, spec), screen.screen_sweep(copy, spec)
    if not torch.equal(s_dev.cpu(), s_cpu):
        raise SystemExit("screen_sweep differs between the device and the CPU")
    for what, a, b in zip(("canon", "n_ops", "breach"), history.canon_sweep(first),
                          history.canon_sweep(copy)):
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
            raise SystemExit(f"canon_sweep's {what} differs between the device and the CPU")
    lanes = int(first.seed.shape[0])
    log(f"checked-sweep parity: etcd lanes 0-{parity_seeds - 1} equal the CPU port on all "
        f"{k} leaves; screen_sweep ({int(s_dev.sum())} suspects) and canon_sweep equal the "
        f"CPU on all {lanes} lanes of the first chunk")
    del first, firsts, copy

    # (b) the stale-read bug, through both decode routes
    wl_s, ecfg_s = etcd_path(stale=True)
    n, chunk = stale
    reports = []
    for decode in (True, False):
        clock = PhaseClock()
        with clock.timing():
            rep, calls, got, wall = main_path_run(dev, lambda: screen.checked_sweep(
                wl_s, ecfg_s, np.arange(n, dtype=np.int64), spec, etcd.sweep_summary,
                chunk_size=chunk, workers=workers, device_decode=decode, device=dev,
                telemetry=clock))
        launches, steps = launches + got, steps + calls
        reports.append(rep)
        out[f"stale_{'device' if decode else 'host'}_decode_wall_s"] = wall
        log(f"stale-read, {'device' if decode else 'host'} decode: wall {wall:.6f} s, "
            f"{n / wall:.3f} seeds/s; {clock.split()}; {rep['hist_suspects']} suspects, "
            f"{rep['hist_unique']} unique histories checked")
    _same_report(reports[0], reports[1], "stale-read report, device vs host decode")
    _same_report(reports[0], goldens(True)[run_key(n, chunk)], "stale-read report vs golden")
    if reports[0]["hist_violations"] <= 0:
        raise SystemExit("the stale-read bug was not caught by the history oracle")
    log(f"stale-read: {n} seeds in chunks of {chunk}: {reports[0]['hist_violations']} "
        f"history violations ({reports[0]['violations']} online), equal across decode "
        "routes and to the golden")
    out["stale"] = reports[0]

    # (d) a mid-run snapshot on the device, resumed on the CPU and here
    n, run_steps = ckpt
    build = os.path.join(HERE, "madsim_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    path = os.path.join(build, "phase9_inflight.npz")
    state = core.init_sweep(wl, ecfg, np.arange(n), device=dev)
    for _ in range(run_steps):
        state = core.step_batch(wl, ecfg, state, device=dev)
    checkpoint.save_sweep(state, path, inflight={"lo": 0, "k": n})

    def resume(device):
        like = core.init_sweep(wl, ecfg, [0], device=device)
        snap = (checkpoint.load_sweep(path, like), checkpoint.load_inflight(path))
        return checkpoint.run_sweep_pipelined(
            wl, ecfg, np.arange(n), etcd.sweep_summary, chunk_size=n, resume_from=snap,
            host_work=screen.history_host_work(spec), device=device,
            screen=lambda final: screen.screen_sweep(final, spec))

    here, calls, got, _ = main_path_run(dev, lambda: resume(dev))
    launches, steps = launches + got, steps + calls
    _same_report(resume("cpu"), here, "resume of the device's snapshot, CPU vs device")
    os.remove(path)
    log(f"checkpoint: {n} seeds saved after {run_steps} steps on {dev.type}, resumed on the "
        f"CPU and on {dev.type} to equal totals ({here['events_total']} events)")
    check.shutdown_pools()
    out.update(launches=launches, steps=steps)
    return out


def _peak_reset(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak(dev) -> int:
    import torch

    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0


def _rates(what: str, seeds: int, events: int, wall: float, calls: int, launches: int,
           dev) -> str:
    return (f"{what}: {seeds} seeds, {calls} step_batch calls, {launches} pop_min launches, "
            f"wall {wall:.6f} s, {seeds / wall:.3f} seeds/s, {events / wall:.3f} events/s, "
            f"peak device memory {_peak(dev)} B")


def _same_summary(got: dict, want: dict, what: str) -> None:
    if got != want:
        raise SystemExit(f"{what}: {json.dumps(got, sort_keys=True)} != "
                         f"{json.dumps(want, sort_keys=True)}")


def _replay_equal(dev, wl, ecfg, seed: int, what: str):
    """``run_traced`` of one seed on ``dev`` against the CPU replay."""
    from madsim_tpu_torch.engine import core

    g_final, g_trace = core.run_traced(wl, ecfg, seed, device=dev)
    _same_replay((g_final, g_trace), core.run_traced(wl, ecfg, seed, device="cpu"), dev, what)
    return g_final, g_trace


def _same_replay(got, cpu, dev, what: str) -> None:
    """A ``run_traced`` result on ``dev`` against the CPU's: every trace
    key and every final leaf."""
    (g_final, g_trace), (c_final, c_trace) = got, cpu
    if sorted(g_trace) != sorted(c_trace):
        raise SystemExit(f"{what}: replay trace keys differ")
    for k in g_trace:
        if not bool((g_trace[k].cpu() == c_trace[k]).all()):
            raise SystemExit(f"{what}: replay trace {k!r} differs between {dev.type} and the CPU")
    _leaves_equal(g_final, c_final, f"{what}: replay final state")


def phase_kafka(dev, seeds: int = KAFKA_RUNS[0], parity_seeds: int = PARITY_SEEDS) -> dict:
    """Phase 10: the kafka sweep (BASELINE #4) against the golden summary,
    lanes 0-63 against the CPU port, and a violating seed's replay."""
    import numpy as np

    from madsim_tpu_torch.engine import core
    from madsim_tpu_torch.models import kafka

    wl, ecfg = kafka_path()
    _peak_reset(dev)
    final, calls, launches, wall = main_path_run(
        dev, lambda: core.run_sweep(wl, ecfg, np.arange(seeds, dtype=np.int64), device=dev))
    summary = kafka.sweep_summary(final)
    log("kafka summary: " + json.dumps(summary, sort_keys=True))
    log(_rates("kafka sweep", seeds, summary["events_total"], wall, calls, launches, dev)
        + f"; loop state {core.state_bytes_per_seed(wl, ecfg)} B/seed, queue "
        f"{ecfg.queue_capacity}")
    if not bool(final.done.all()):
        raise SystemExit("the kafka sweep hit max_steps before every seed finished")
    _same_summary(summary, load_golden("kafka_summary.json")["summaries"][f"seeds={seeds}"],
                  "kafka summary vs golden")
    cpu = core.run_sweep(wl, ecfg, list(range(parity_seeds)), device="cpu")
    n = _leaves_equal(cpu, core.lane_slice(final, parity_seeds, 0),
                      f"kafka lanes 0-{parity_seeds - 1} vs the CPU port")
    del final
    wl_b, ecfg_b = kafka_path(bug=True)
    b_final, b_trace = _replay_equal(dev, wl_b, ecfg_b, KAFKA_REPLAY_SEED, "kafka")
    if not bool(b_final.wstate.violation):
        raise SystemExit(f"kafka replay seed {KAFKA_REPLAY_SEED} did not violate")
    log(f"kafka: summary = golden; lanes 0-{parity_seeds - 1} equal the CPU port on all {n} "
        f"leaves; ack-on-append seed {KAFKA_REPLAY_SEED} ({int(b_trace['fired'].sum())} "
        f"events, violation kind {int(b_final.wstate.viol_kind)}) replays on {dev.type} "
        "as on the CPU")
    return {"launches": launches, "steps": calls, "wall_s": wall, "summary": summary}


def phase_s3(dev, seeds: int = S3_RUNS[0], bug_seeds: int = S3_BUG_RUNS[0],
             parity_seeds: int = PARITY_SEEDS) -> dict:
    """Phase 11: the S3 sweep and its ack-before-durable bug against their
    golden summaries, lanes 0-63 against the CPU port."""
    import numpy as np

    from madsim_tpu_torch.engine import core
    from madsim_tpu_torch.models import s3

    launches = steps = 0
    out = {}
    for bug, n in ((False, seeds), (True, bug_seeds)):
        wl, ecfg = s3_path(bug)
        _peak_reset(dev)
        final, calls, got, wall = main_path_run(
            dev, lambda: core.run_sweep(wl, ecfg, np.arange(n, dtype=np.int64), device=dev))
        launches, steps = launches + got, steps + calls
        summary = s3.sweep_summary(final)
        name = "s3_bug_summary.json" if bug else "s3_summary.json"
        what = "S3 ack-before-durable" if bug else "S3"
        log(f"{what} summary: " + json.dumps(summary, sort_keys=True))
        log(_rates(f"{what} sweep", n, summary["events_total"], wall, calls, got, dev)
            + f"; loop state {core.state_bytes_per_seed(wl, ecfg)} B/seed, queue "
            f"{ecfg.queue_capacity}")
        if not bool(final.done.all()):
            raise SystemExit(f"the {what} sweep hit max_steps before every seed finished")
        _same_summary(summary, load_golden(name)["summaries"][f"seeds={n}"],
                      f"{what} summary vs golden")
        if bug and summary["violations"] <= 0:
            raise SystemExit("the ack-before-durable bug was not caught")
        if not bug:
            cpu = core.run_sweep(wl, ecfg, list(range(parity_seeds)), device="cpu")
            k = _leaves_equal(cpu, core.lane_slice(final, parity_seeds, 0),
                              f"S3 lanes 0-{parity_seeds - 1} vs the CPU port")
            log(f"S3: lanes 0-{parity_seeds - 1} equal the CPU port on all {k} leaves")
        out["bug" if bug else "clean"] = {"wall_s": wall, "summary": summary}
        del final
    log(f"S3: both summaries = golden; the bug violates on {out['bug']['summary']['violations']}"
        f" of {bug_seeds} seeds")
    out.update(launches=launches, steps=steps)
    return out


def phase_kafka_checked(dev, clean=KAFKA_CLEAN_RUNS[0], bug=KAFKA_BUG_RUNS[0],
                        workers: int = CHECK_WORKERS) -> dict:
    """Phase 12: the checked kafka sweep, clean and with the ack-on-append
    bug, against their golden reports; the first chunk's log screen on
    the device against the CPU on every lane."""
    import numpy as np
    import torch

    from madsim_tpu_torch.engine import tree
    from madsim_tpu_torch.models import kafka
    from madsim_tpu_torch.oracle import check, screen

    spec = kafka.history_spec()
    launches = steps = 0
    out = {}
    for is_bug, (n, chunk) in ((False, clean), (True, bug)):
        wl, ecfg = kafka_checked_path(is_bug)
        firsts = []
        clock = PhaseClock()
        _peak_reset(dev)
        with clock.timing(keep=firsts):
            report, calls, got, wall = main_path_run(dev, lambda: screen.checked_sweep(
                wl, ecfg, np.arange(n, dtype=np.int64), spec, kafka.sweep_summary,
                chunk_size=chunk, workers=workers, device=dev, telemetry=clock))
        launches, steps = launches + got, steps + calls
        name = "kafka_checked_bug.json" if is_bug else "kafka_checked_clean.json"
        what = "checked kafka, ack-on-append" if is_bug else "checked kafka"
        log(f"{what}: " + json.dumps(report, sort_keys=True))
        log(_rates(what, n, report["events_total"], wall, calls, got, dev)
            + f"; {n // chunk} chunks of {chunk}; {clock.split()}; {report['hist_suspects']} "
            f"suspects, {report['hist_violations']} history violations, "
            f"{report['violations']} online")
        _same_report(report, load_golden(name)["reports"][run_key(n, chunk)],
                     f"{what} vs golden")
        if is_bug and report["violations"] <= 0:
            raise SystemExit("the ack-on-append bug was not caught")
        if not is_bug:
            first = firsts[0]
            copy = tree.map(lambda a: a.cpu(), first)
            s_dev, s_cpu = screen.screen_sweep(first, spec), screen.screen_sweep(copy, spec)
            if not torch.equal(s_dev.cpu(), s_cpu):
                raise SystemExit("the log screen differs between the device and the CPU")
            log(f"checked kafka: the log screen of the first chunk ({int(s_dev.sum())} "
                f"suspects, histories up to {int(first.hist_len.max())} rows) equals the CPU's "
                f"on all {int(first.seed.shape[0])} lanes")
            del first, firsts, copy
        out["bug" if is_bug else "clean"] = {"wall_s": wall, "report": report,
                                             "phases_s": clock.seconds}
    check.shutdown_pools()
    out.update(launches=launches, steps=steps)
    return out


def phase_stream(dev, run=STREAM_RUNS[0], pool: int = STREAM_POOL[0],
                 workers: int = CHECK_WORKERS) -> dict:
    """Phase 13: the stream against the chunked driver and the golden
    (a), with its warmed second call building no kernel; the checked
    sweep through both drivers (b); an interrupted stream resumed on the
    device (c)."""
    import numpy as np

    from madsim_tpu_torch.engine import checkpoint, compiles, stream
    from madsim_tpu_torch.models import etcd
    from madsim_tpu_torch.oracle import check, history, screen

    wl, ecfg = stream_path()
    n, chunk = run
    seeds = np.arange(n, dtype=np.int64)
    golden = load_golden("etcd_stream.json")
    key = run_key(n, chunk)
    launches = steps = 0
    kw = dict(chunk_size=chunk, pool_size=pool, round_steps=STREAM_ROUND_STEPS, device=dev)

    # (a) chunked, then the stream twice: the second call inside the
    # compile counter
    _peak_reset(dev)
    chunked, calls, got, c_wall = main_path_run(dev, lambda: checkpoint.run_sweep_pipelined(
        wl, ecfg, seeds, etcd.sweep_summary, chunk_size=chunk, device=dev))
    launches, steps = launches + got, steps + calls
    log(_rates("stream phase, chunked driver", n, chunked["events_total"], c_wall, calls, got,
               dev) + f"; {-(-n // chunk)} chunks of {chunk}")
    _same_summary(chunked, golden["totals"][key], "chunked totals vs golden")
    walls = []
    for i in range(2):
        stats: dict = {}
        _peak_reset(dev)
        with compiles.count_compiles() as counter:
            streamed, calls, got, wall = main_path_run(dev, lambda: stream.stream_sweep(
                wl, ecfg, seeds, etcd.sweep_summary, stats=stats, **kw))
        launches, steps = launches + got, steps + calls
        walls.append(wall)
        log(_rates(f"stream call {i + 1}", n, streamed["events_total"], wall, calls, got, dev)
            + f"; pool {pool}, chunk {chunk}, {stats['rounds']} rounds, {stats['refills']} "
            f"refills, occupancy_mean {stats['occupancy_mean']:.6f}; {counter.count} compiles "
            f"{counter.events}")
        _same_summary(streamed, chunked, f"stream call {i + 1} vs chunked")
        if i == 1 and counter.count:
            raise SystemExit(f"the warmed stream compiled: {counter.events}")
    log(f"stream: totals = chunked = golden ({chunked['events_total']} events, "
        f"{chunked['violations']} online violations); stream/chunked wall "
        f"{walls[1] / c_wall:.6f}; the warmed call built and loaded no kernel (0 by "
        "construction once phase 2 has loaded them)")
    out = {"chunked_wall_s": c_wall, "stream_wall_s": walls, "occupancy_mean":
           stats["occupancy_mean"], "rounds": stats["rounds"], "refills": stats["refills"]}

    # (b) the checked sweep through both drivers, the checker's pool
    # started first so that neither driver's host checking pays for it
    spec = etcd.history_spec()
    empty = history.History(seed=0, ops=(), overflow=False, rows=0)
    check.check_histories([empty] * (4 * workers), spec, workers=workers)
    reports = {}
    for driver in ("stream", "chunked"):
        clock = PhaseClock()
        rep, calls, got, wall = main_path_run(dev, lambda: screen.checked_sweep(
            wl, ecfg, seeds, spec, etcd.sweep_summary, chunk_size=chunk, workers=workers,
            driver=driver, device=dev, telemetry=clock))
        launches, steps = launches + got, steps + calls
        reports[driver] = rep
        out[f"checked_{driver}_wall_s"] = wall
        log(_rates(f"checked sweep, driver={driver}", n, rep["events_total"], wall, calls, got,
                   dev) + f"; host checking {clock.seconds.get('oracle_check_seconds', 0.0):.6f}"
            f" s; {rep['hist_suspects']} suspects, {rep['hist_violations']} history violations")
    _same_report(reports["stream"], reports["chunked"], "checked report, stream vs chunked")
    _same_report(reports["stream"], golden["checked"][key], "checked report vs golden")
    check.shutdown_pools()

    # (c) interrupted after two rounds on the device, then resumed there
    build = os.path.join(HERE, "madsim_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    path = os.path.join(build, "phase13_stream.npz")
    partial, calls, got, stop_wall = main_path_run(dev, lambda: stream.stream_sweep(
        wl, ecfg, seeds, etcd.sweep_summary, ckpt_path=path, stop_after_rounds=2, **kw))
    launches, steps = launches + got, steps + calls
    resumed, calls, got, resume_wall = main_path_run(dev, lambda: stream.stream_sweep(
        wl, ecfg, seeds, etcd.sweep_summary, resume_from=path, **kw))
    launches, steps = launches + got, steps + calls
    size = os.path.getsize(path)
    os.remove(path)
    _same_summary(resumed, chunked, "resumed stream vs uninterrupted")
    log(f"stream: stopped after 2 rounds ({partial.get('seeds', 0)} seeds flushed; "
        f"{stop_wall:.6f} s, snapshot {size} B), resumed on {dev.type} ({resume_wall:.6f} s) "
        "to totals equal to the uninterrupted run's")
    out.update(launches=launches, steps=steps, report=reports["stream"])
    return out

# phases 14-15 run their sweeps on the ranks of a parallel.World: these
# jobs run in each rank (spawned processes that import this module) and
# return host values


def _rank_checked(mesh, n: int, cpd: int, workers: int) -> dict:
    """Phase 14 on one rank: the clean checked etcd sweep on the mesh,
    rank 0's checker pool (the host phase runs there alone) started
    before the timed region."""
    import numpy as np

    from madsim_tpu_torch.models import etcd
    from madsim_tpu_torch.oracle import check, history, screen

    dev = mesh.device
    spec = etcd.history_spec()
    wl, ecfg = etcd_path()
    if workers and mesh.rank == 0:
        empty = history.History(seed=0, ops=(), overflow=False, rows=0)
        check.check_histories([empty] * (4 * workers), spec, workers=workers)
    _peak_reset(dev)
    report, calls, launches, wall = main_path_run(dev, lambda: screen.checked_sweep(
        wl, ecfg, np.arange(n, dtype=np.int64), spec, etcd.sweep_summary, mesh=mesh,
        chunk_per_device=cpd, workers=workers))
    check.shutdown_pools()
    return {"report": report, "calls": calls, "launches": launches, "wall": wall,
            "peak": _peak(dev), "device": str(dev)}


def _rank_flagship(mesh, n: int) -> dict:
    """Phase 14 on one rank: the flagship's seeds ``0..n-1`` through
    ``run_sweep_sharded``."""
    import numpy as np

    from madsim_tpu_torch import parallel
    from madsim_tpu_torch.models import raft

    wl, ecfg = flagship()
    _peak_reset(mesh.device)
    final, calls, launches, wall = main_path_run(mesh.device, lambda: parallel.run_sweep_sharded(
        wl, ecfg, np.arange(n, dtype=np.int64), mesh))
    return {"summary": raft.sweep_summary(final), "calls": calls, "launches": launches,
            "wall": wall, "peak": _peak(mesh.device)}


_RANK_COUNTER: dict = {}


def _rank_count(mesh, start: bool):
    """Start counting a rank's batched steps (``core.StepCount``), or stop
    and return ``{"calls", "launches"}``: the counting around a run this
    script does not call itself (``dryrun_multichip``)."""
    from madsim_tpu_torch.engine import core

    del mesh
    if start:
        _RANK_COUNTER["count"] = core.StepCount().start()
        return None
    count = _RANK_COUNTER.pop("count").stop()
    return {"calls": count.batched, "launches": count.launches}


def _rank_campaign(mesh, run, path: str) -> dict:
    """Phase 15 on one rank: ``sharded_campaign`` of the amnesia gate."""
    from madsim_tpu_torch.explore import CampaignConfig, sharded_campaign
    from madsim_tpu_torch.explore.targets import amnesia_gate

    target, base = amnesia_gate(smoke=False)
    rounds, spr, chunk = run
    ccfg = CampaignConfig(rounds=rounds, seeds_per_round=spr, chunk_size=chunk)
    _peak_reset(mesh.device)
    metrics, calls, launches, wall = main_path_run(mesh.device, lambda: sharded_campaign(
        target, base, ccfg, mesh.size, report_path=path, mesh=mesh))
    return {"metrics": metrics, "calls": calls, "launches": launches, "wall": wall,
            "peak": _peak(mesh.device)}


def _rank_line(what: str, seeds: int, events: int, ranks: list) -> str:
    """Wall (the slowest rank's), rates, per-rank peaks and counts."""
    wall = max(r["wall"] for r in ranks)
    return (f"{what}: {seeds} seeds, wall {wall:.6f} s, {seeds / wall:.3f} seeds/s, "
            f"{events / wall:.3f} events/s, peak device memory per rank "
            f"{[r['peak'] for r in ranks]} B, pop_min launches {[r['launches'] for r in ranks]}"
            f" vs step_batch calls {[r['calls'] for r in ranks]}")


def _counted(dev, ranks: list, what: str):
    """Launches and calls summed over the ranks; on the card they must be
    equal."""
    calls = sum(r["calls"] for r in ranks)
    launches = sum(r["launches"] for r in ranks)
    if dev.type == "cuda" and launches != calls:
        raise SystemExit(f"{what}: pop_min launches ({launches}) != step_batch calls ({calls})")
    return launches, calls


def phase_mesh(dev, run=MESH_RUNS[0], worlds=MESH_WORLDS,
               flagship_seeds: int = MESH_FLAGSHIP_SEEDS, workers: int = CHECK_WORKERS) -> dict:
    """Phase 14: phase 9's clean checked etcd sweep at each world size
    (NCCL for one rank on the card, gloo for ranks sharing it), the global
    chunk the same, against phase 9's golden report; at world size 2, the
    flagship's seeds 0-63 through ``run_sweep_sharded`` against the golden
    summary."""
    from madsim_tpu_torch.parallel import World

    n, chunk = run
    want = load_golden("etcd_checked_clean.json")["reports"][run_key(n, chunk)]
    flag_want = load_golden("flagship_summary.json")["summary"]
    launches = steps = 0
    out = {"walls": {}}
    for w in worlds:
        t0 = time.perf_counter()
        with World(w, device=dev.type) as world:
            up = time.perf_counter() - t0
            ranks = world.run(_rank_checked, n, chunk // w, workers)
            for r, got in enumerate(ranks):
                _same_report(got["report"], want, f"checked sweep, rank {r} of {w}")
            got, calls = _counted(dev, ranks, f"checked sweep on {w} rank(s)")
            launches, steps = launches + got, steps + calls
            out["walls"][w] = max(r["wall"] for r in ranks)
            log(_rank_line(f"mesh: checked etcd sweep on {w} rank(s) ({world.backend}, "
                           f"{[r['device'] for r in ranks]}; spawn and init {up:.3f} s; "
                           f"{chunk // w} lanes per rank per chunk)", n,
                           want["events_total"], ranks) + "; report = golden")
            if w == 2 and flagship_seeds:
                ranks = world.run(_rank_flagship, flagship_seeds)
                for r, got in enumerate(ranks):
                    _same_summary(got["summary"], flag_want, f"flagship, rank {r} of 2")
                got, calls = _counted(dev, ranks, "flagship on 2 ranks")
                launches, steps = launches + got, steps + calls
                log(_rank_line("mesh: flagship run_sweep_sharded on 2 ranks", flagship_seeds,
                               flag_want["events_total"], ranks) + "; summary = golden")
    if len(out["walls"]) == 2:
        w1, w2 = (out["walls"][w] for w in worlds)
        log(f"mesh: checked sweep wall, world size {worlds[1]} / {worlds[0]}: {w2 / w1:.6f}")
    out.update(launches=launches, steps=steps)
    return out


def phase_campaign(dev, curve=CURVE_RUNS[0], run=CAMPAIGN_RUNS[0],
                   n: int = CAMPAIGN_WORLD) -> dict:
    """Phase 15: ``entry.dryrun_multichip(n)`` on the device (its curve's
    report hash per world size against the JAX golden's), then
    ``sharded_campaign`` of the amnesia gate on ``n`` ranks against its
    JAX-made golden report (sha256 of the JSONL bytes)."""
    import hashlib

    from madsim_tpu_torch import entry
    from madsim_tpu_torch.parallel import World

    key = campaign_key(*run)
    goldens = load_golden(CAMPAIGN_GOLDEN)
    golden = goldens["reports"][key]
    curve_want = goldens["curves"][curve_key(curve[0], curve[1])]
    build = os.path.join(HERE, "madsim_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    path = os.path.join(build, "phase15_campaign.jsonl")
    out = {}
    with World(n, device=dev.type) as world:
        world.run(_rank_count, True)
        t0 = time.perf_counter()
        dry = entry.dryrun_multichip(n, device=dev, curve_seeds=curve[0], curve_chunk=curve[1],
                                     curve_warm=curve[2], world=world)
        d_wall = time.perf_counter() - t0
        d_launches, d_calls = _counted(dev, world.run(_rank_count, False), "dry run")
        log(f"dryrun_multichip({n}) on {dev.type} ({world.backend}): {d_wall:.6f} s, "
            f"{d_launches} pop_min launches = {d_calls} step_batch calls over the ranks; curve "
            + json.dumps([{k: p[k] for k in ("devices", "wall_s", "seeds_per_sec",
                                             "violations", "report_sha256")}
                          for p in dry["curve"]["curve"]])
            + f"; bytes_invariant {dry['curve']['bytes_invariant']}")
        for p in dry["curve"]["curve"]:
            want = curve_want["report_sha256"][str(p["devices"])]
            if p["report_sha256"] != want:
                raise SystemExit(f"curve report at world size {p['devices']}: sha256 "
                                 f"{p['report_sha256']} != the JAX golden's {want}")
        log("dry run curve: report sha256 = the JAX golden's at world sizes "
            f"{[p['devices'] for p in dry['curve']['curve']]} (the reference's hist_unique "
            f"{curve_want['hist_unique']}, its bytes_invariant {curve_want['bytes_invariant']})")
        ranks = world.run(_rank_campaign, run, path)
    metrics = ranks[0]["metrics"]
    with open(path, "rb") as f:
        blob = f.read()
    os.remove(path)
    sha = hashlib.sha256(blob).hexdigest()
    if sha != golden["sha256"] or metrics["report_sha256"] != sha:
        raise SystemExit(f"campaign report sha256 {sha} != golden {golden['sha256']}: "
                         f"{blob.decode()[:2000]}")
    c_launches, c_calls = _counted(dev, ranks, "campaign")
    log(_rank_line(f"campaign ({key}) on {n} ranks", metrics["seeds_swept"],
                   metrics["events_total"], ranks)
        + f"; {metrics['rounds']} rounds, {metrics['violations_total']} violations, "
        f"{metrics['distinct_failures']} distinct failures, corpus {metrics['corpus_size']}, "
        f"time to first bug {metrics['time_to_first_bug_s']} s; report sha256 = golden")
    out.update(launches=d_launches + c_launches, steps=d_calls + c_calls, dry_wall=d_wall,
               metrics=metrics)
    return out


# phase 16's configs, built in either package (``explore`` and
# ``FaultSpec`` are the port's or, to make the goldens, the reference's)


def steer_configs(explore, run):
    """The steered campaign's ``(CampaignConfig, SteerConfig)``."""
    spr, budget, recorded = run
    ccfg = explore.CampaignConfig(rounds=999, seeds_per_round=spr,
                                  campaign_seed=STEER_CAMPAIGN_SEED,
                                  max_recorded_seeds=recorded, scheduler="bandit")
    scfg = explore.SteerConfig(families=STEER_FAMILIES, escalate_seeds=STEER_ESCALATE_SEEDS,
                               kill_plays=STEER_KILL_PLAYS, budget_events=budget)
    return ccfg, scfg


def steer_key(run) -> str:
    return "seeds_per_round={} budget_events={} max_recorded_seeds={}".format(*run)


def fleet_setup(explore, fault_spec, run):
    """The fleet drill's ``(target, base spec, CampaignConfig)``."""
    spr, recorded, _ = run
    ccfg = explore.CampaignConfig(seeds_per_round=spr, chunk_size=spr,
                                  max_recorded_seeds=recorded, **FLEET_CAMPAIGN)
    return explore.amnesia_raft_target(**FLEET_TARGET), fault_spec(**FLEET_BASE), ccfg


def fleet_key(run) -> str:
    return "seeds_per_round={} max_recorded_seeds={} shrink_tests={}".format(*run)


def diff_config(explore, run):
    return explore.DifferentialConfig(seeds=run[0], sim_seconds=run[1])


def diff_key(run) -> str:
    return "seeds={} sim_seconds={}".format(*run)


def _build_dir() -> str:
    build = os.path.join(HERE, "madsim_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    return build


@contextlib.contextmanager
def _timed_calls(module, name: str):
    """Count the calls of ``module.name``, their seconds and what they
    returned while the block runs (a dict ``{"calls", "seconds",
    "returned"}``)."""
    fn = getattr(module, name)
    box = {"calls": 0, "seconds": 0.0, "returned": []}

    def timed(*args, **kwargs):
        t = time.perf_counter()
        try:
            out = fn(*args, **kwargs)
        finally:
            box["calls"] += 1
            box["seconds"] += time.perf_counter() - t
        box["returned"].append(out)
        return out

    setattr(module, name, timed)
    try:
        yield box
    finally:
        setattr(module, name, fn)


def _steps_line(r: dict) -> str:
    return (f"pop_min launches {r['launches']} = engine steps {r['calls'] + r['replay_steps']} "
            f"({r['calls']} batched steps + {r['replay_steps']} one-lane replay steps), "
            f"{r['captures']} step graphs captured, wall {r['wall']:.6f} s, peak device memory {r['peak']} B")


def phase_steer(dev, run=STEER_RUNS[0]) -> dict:
    """Phase 16 (a): the steered campaign (``run_steered`` through
    ``run_campaign``'s ``scheduler="bandit"`` route) of the raft steer
    gate; its JSONL report and decision trace against the JAX-made
    golden's sha256s, and its fingerprints; the triage replays timed."""
    import hashlib

    from madsim_tpu_torch import explore

    # the module (the package's ``triage`` is the function of that name)
    triage = sys.modules["madsim_tpu_torch.explore.triage"]
    golden = load_golden(STEER_GOLDEN)["runs"][steer_key(run)]
    target, base = explore.steer_gate(smoke=True)
    ccfg, scfg = steer_configs(explore, run)
    build = _build_dir()
    paths = [os.path.join(build, f"phase16_steer_{what}.jsonl") for what in ("report", "trace")]
    _peak_reset(dev)
    with _timed_calls(triage, "triage_seed") as replays:
        r = engine_steps_run(dev, lambda: explore.run_campaign(
            target, base, ccfg, steer_cfg=scfg, report_path=paths[0], trace_path=paths[1],
            device=dev))
    blobs = []
    for path in paths:
        with open(path, "rb") as f:
            blobs.append(f.read())
        os.remove(path)
    shas = [hashlib.sha256(b).hexdigest() for b in blobs]
    if shas != [golden["report_sha256"], golden["trace_sha256"]]:
        raise SystemExit(f"steered campaign ({steer_key(run)}): report/trace sha256 {shas} != "
                         f"golden {[golden['report_sha256'], golden['trace_sha256']]}:\n"
                         f"{blobs[0].decode()[:2000]}")
    lines = [json.loads(line) for line in blobs[0].decode().splitlines()[1:]]
    trace = [json.loads(line) for line in blobs[1].decode().splitlines()[1:]]
    fps = sorted({fp for rec in lines for fp in rec["fresh_fingerprints"]})
    if fps != golden["fingerprints"]:
        raise SystemExit(f"steered campaign fingerprints {fps} != golden {golden['fingerprints']}")
    kinds = [d["kind"] for d in trace]
    seeds = sum(rec["seeds"][1] - rec["seeds"][0] for rec in lines)
    events = sum(rec["events_total"] for rec in lines)
    spent, first_bug = 0, None
    for rec in lines:
        spent += rec["events_total"]
        if rec["violations"] > 0:
            first_bug = spent
            break
    bits = max((rec["coverage_total_bits"] for rec in lines), default=0)
    log(f"steered campaign ({steer_key(run)}) on {dev.type}: {kinds.count('decide')} decisions, "
        f"{kinds.count('kill')} kills, {kinds.count('escalate')} escalations; {len(fps)} distinct "
        f"fingerprints {fps}, {bits} coverage bits; events to first bug {first_bug}, "
        f"{events} events spent, {seeds} seeds swept; {seeds / r['wall']:.3f} seeds/s, "
        f"{events / r['wall']:.3f} events/s; {_steps_line(r)}; triage replays "
        f"{replays['calls']} in {replays['seconds']:.6f} s"
        + (f" ({replays['seconds'] / replays['calls']:.6f} s each)" if replays["calls"] else "")
        + "; report and trace sha256 = golden")
    replays.pop("returned")
    return {"launches": r["launches"], "steps": r["calls"] + r["replay_steps"],
            "decisions": kinds.count("decide"), "fingerprints": fps, "wall": r["wall"],
            "replays": replays}


def fleet_worker_run(device: str, root: str, name: str, run, max_units=None) -> dict:
    """One fleet worker of phase 16 (b) on ``device``: ``run_worker`` into
    the store at ``root``, its engine steps, triage replays and shrinks
    counted."""
    import torch

    from madsim_tpu_torch import explore
    from madsim_tpu_torch.engine.faults import FaultSpec
    from madsim_tpu_torch.explore import orchestrator

    dev = torch.device(device)
    target, base, ccfg = fleet_setup(explore, FaultSpec, run)
    store = explore.CorpusStore(root, worker=name)
    _peak_reset(dev)
    with _timed_calls(orchestrator, "triage_seed") as triaged, \
            _timed_calls(orchestrator, "shrink") as shrunk:
        r = engine_steps_run(dev, lambda: explore.run_worker(
            target, base, ccfg, store, FLEET_UNITS, max_units=max_units,
            shrink_tests=run[2], device=dev))
    res = r.pop("out")
    # a shrink replays the seed once to triage it, once to extract its
    # schedule, then once per ddmin candidate (ShrinkResult.tests)
    shrunk["replays"] = sum(2 + (0 if sr is None else sr.tests) for sr in shrunk.pop("returned"))
    triaged.pop("returned")
    return dict(r, units=res["units"], fingerprints=res["fingerprints"], triage=triaged,
                shrink=shrunk)


def _fleet_worker(device: str, root: str, name: str, run, max_units, results) -> None:
    """A fleet worker process of phase 16 (b)'s pair."""
    import traceback

    try:
        results.put((name, "ok", fleet_worker_run(device, root, name, run, max_units)))
    except (Exception, SystemExit):
        results.put((name, "error", traceback.format_exc()))


def _fleet_pair(device: str, root: str, run, timeout_s: float = 1200.0) -> list:
    """Two worker processes on ``device`` splitting the drill's units
    (``max_units=1`` each), started together like fleet_smoke's."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_fleet_worker, args=(device, root, f"w{i}", run, 1, results))
             for i in range(2)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < len(procs):
            try:
                name, kind, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.name for p in procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    raise SystemExit(f"fleet pair: worker(s) {dead} died or timed out")
                continue
            if kind == "error":
                raise SystemExit(f"fleet worker {name} failed:\n{value}")
            out[name] = value
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[f"w{i}"] for i in range(len(procs))]


def phase_fleet(dev, run=FLEET_RUNS[0]) -> dict:
    """Phase 16 (b): the fleet drill — one worker, then a pair of worker
    processes on the same device, each merged report equal to the other
    and to the JAX-made golden; then ``regression_gate`` over the JAX
    package's own store of the card's drill."""
    import shutil

    from madsim_tpu_torch import explore

    golden = load_golden(FLEET_GOLDEN)["runs"][fleet_key(run)]
    build = _build_dir()
    roots = [os.path.join(build, f"phase16_fleet_{what}") for what in ("solo", "pair", "gate")]
    for root in roots:
        shutil.rmtree(root, ignore_errors=True)
    # the pair runs in its own processes beside the solo worker (two
    # stores; each process host-paced on its own core)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        pair_job = pool.submit(_fleet_pair, dev.type, roots[1], run)
        solo = fleet_worker_run(dev.type, roots[0], "solo", run)
        pair = pair_job.result()
    both_wall = time.perf_counter() - t0
    reports = [explore.merged_report(explore.CorpusStore(root, worker="report"))
               for root in roots[:2]]
    if reports[0] != reports[1] or reports[0] != golden["report"]:
        raise SystemExit(f"fleet merged reports differ (solo = pair: {reports[0] == reports[1]}; "
                         f"solo = golden: {reports[0] == golden['report']}):\n{reports[0][:2000]}")
    if sorted(u for w in pair for u in w["units"]) != list(range(FLEET_UNITS)):
        raise SystemExit(f"fleet pair leased {[w['units'] for w in pair]}")
    launches = solo["launches"] + sum(w["launches"] for w in pair)
    steps = sum(w["calls"] + w["replay_steps"] for w in [solo] + pair)
    for what, w in [("solo worker", solo)] + [(f"pair worker {i}", w) for i, w in enumerate(pair)]:
        log(f"fleet ({fleet_key(run)}) {what} on {dev.type}: units {w['units']}, fingerprints "
            f"{w['fingerprints']}; {_steps_line(w)}; triage replays {w['triage']['calls']} in "
            f"{w['triage']['seconds']:.6f} s; shrinks {w['shrink']['calls']} ("
            f"{w['shrink']['replays']} replays) in {w['shrink']['seconds']:.6f} s")
    log(f"fleet: the solo worker and the pair's processes, side by side, in {both_wall:.6f} s "
        "(the pair's spawn included); merged report = solo's = golden")

    from madsim_tpu_torch.engine.faults import FaultSpec

    shutil.copytree(data_path(FLEET_STORE), roots[2])
    target, _, _ = fleet_setup(explore, FaultSpec, run)
    _peak_reset(dev)
    with _timed_calls(explore.orchestrator, "triage_seed") as replays:
        r = engine_steps_run(dev, lambda: explore.regression_gate(
            explore.CorpusStore(roots[2], worker="gate"), target, device=dev))
    gate = r["out"]
    if not gate["ok"] or gate["checked"] < 1:
        raise SystemExit(f"regression gate over the JAX package's store: {gate}")
    log(f"regression gate over the JAX package's store on {dev.type}: {gate['checked']} checked, "
        f"{gate['skipped']} skipped, ok; {replays['calls']} triage replays in "
        f"{replays['seconds']:.6f} s; {_steps_line(r)}")
    for root in roots:
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches + r["launches"], "steps": steps + r["calls"] + r["replay_steps"],
            "solo": solo, "pair": pair, "gate": gate}


def phase_differential(dev, run=DIFF_RUNS[0], grid=DIFF_GRID_RUNS[0], card: str = "") -> dict:
    """Phase 16 (c): ``run_differential`` over ``gate_specs()``, its host
    half computed live on the port's host runtime (each spec's outcomes
    held to ``differential_host.json`` and timed), its report bytes
    against the JAX-made report; then ``device_outcomes_grid`` at card
    width against the JAX-made ``TierOutcome``s. The host-side decode
    and check of every lane (``_fold_device``) is timed apart, inside the
    wall."""
    from madsim_tpu_torch import explore
    from madsim_tpu_torch.explore import differential

    golden = load_golden(DIFF_GOLDEN)
    host_golden = load_golden(DIFF_HOST_GOLDEN)["host"]
    specs = differential.gate_specs()
    out = {"launches": 0, "steps": 0}
    for what, cfg_run in (("run_differential", run), ("device_outcomes_grid", grid)):
        dcfg = diff_config(explore, cfg_run)
        fold = {"calls": 0, "seconds": 0.0, "events": 0}
        inner = differential._fold_device
        hosts = contextlib.nullcontext({"calls": 0, "seconds": 0.0, "returned": []})
        if what == "run_differential":
            hosts = _timed_calls(differential, "host_outcomes")

        def timed_fold(final, cfg):
            t = time.perf_counter()
            res = inner(final, cfg)
            fold["seconds"] += time.perf_counter() - t
            fold["calls"] += 1
            fold["events"] += int(final.ctr.sum())
            return res

        differential._fold_device = timed_fold
        _peak_reset(dev)
        try:
            with hosts as host_box:
                if what == "run_differential":
                    r = engine_steps_run(dev, lambda: differential.run_differential(
                        specs, dcfg, device=dev))
                    got = json.dumps(r["out"], sort_keys=True) + "\n"
                    want = golden["reports"][diff_key(cfg_run)]
                else:
                    r = engine_steps_run(dev, lambda: differential.device_outcomes_grid(
                        specs, dcfg, device=dev))
                    got = [o._asdict() for o in r["out"]]
                    want = golden["grids"][diff_key(cfg_run)]
        finally:
            differential._fold_device = inner
        if got != want:
            raise SystemExit(f"{what} ({diff_key(cfg_run)}) != the JAX-made golden: {got}")
        host_line = ""
        if what == "run_differential":
            live = [o._asdict() for o in host_box["returned"]]
            if live != [host_golden[differential.host_key(s, dcfg)] for s in specs]:
                raise SystemExit(f"live host outcomes ({diff_key(cfg_run)}) != "
                                 f"{DIFF_HOST_GOLDEN}: {live}")
            host_seeds = len(specs) * dcfg.seeds
            out["host_seconds"] = host_box["seconds"]
            out["host_seeds_per_s"] = host_seeds / host_box["seconds"]
            host_line = (f"; the host half live on the port's host runtime ({host_loop()}): "
                         f"{host_seeds} host "
                         f"seeds in {host_box['seconds']:.6f} s of the wall, "
                         f"{out['host_seeds_per_s']:.3f} host seeds/s, = {DIFF_HOST_GOLDEN}")
        seeds = len(specs) * dcfg.seeds
        log(f"{what} ({diff_key(cfg_run)}, {len(specs)} specs) on {dev.type}: {seeds} lanes, "
            f"{seeds / r['wall']:.3f} seeds/s, {fold['events'] / r['wall']:.3f} events/s "
            f"({fold['events']} events); host decode and check of every lane "
            f"{fold['seconds']:.6f} s of the wall; {_steps_line(r)}; = golden{host_line}{card}")
        out["launches"] += r["launches"]
        out["steps"] += r["calls"] + r["replay_steps"]
        out[what] = r["wall"]
    return out


def host_loop() -> str:
    """Which loop the port's host tier runs on in this process."""
    if sys.modules["madsim_tpu_torch.time"]._simloop is not None:
        return "on the compiled core, native/simloop.c"
    return "on the pure-Python loop"


def host_result(result: dict, encode=None) -> dict:
    """What phase 17 holds of a host-tier reproduction: its counters and
    the sha256 and length of its history's canonical bytes (``encode``,
    by default the port's ``history_bytes``; the golden is made with the
    reference's)."""
    import hashlib

    if encode is None:
        from madsim_tpu_torch.oracle.history import history_bytes as encode

    blob = encode(result["history"])
    return {"host_seed": result["host_seed"], "leaders_elected": result["leaders_elected"],
            "violations": result["violations"], "msgs": result["msgs"],
            "history_sha256": hashlib.sha256(blob).hexdigest(), "history_len": len(blob)}


def replay_on_host(replay, raft_host, plan, num_nodes: int):
    """Stage 4 of the pipeline: the plan applied to the host-tier raft
    example, host seeds scanned until the violation reproduces."""
    return replay.replay_on_host(
        lambda hs, p: raft_host.run_seed_with_plan(hs, p, n=num_nodes,
                                                   sim_seconds=REPLAY_SIM_SECONDS),
        plan, host_seeds=range(REPLAY_HOST_SEEDS))


def phase_cross_tier(dev, seeds: int = REPLAY_RUNS[0], card: str = "") -> dict:
    """Phase 17, the cross-tier replay: (a) the amnesia sweep on ``dev``,
    launches = ``step_batch`` calls, the violating seeds among lanes
    0-159 equal to the golden's; (b) ``run_traced`` of the second
    violating seed on ``dev`` equal to the CPU's, its fault plan equal to
    ``faults.compile_host`` and to the golden's; (c) ``replay_on_host`` of
    that plan on the port's host runtime, equal to the golden's
    reproduction."""
    import numpy as np

    from madsim_tpu_torch import faults, replay
    from madsim_tpu_torch.engine import core
    from madsim_tpu_torch.examples import raft_host
    from madsim_tpu_torch.models import raft

    golden = load_golden(REPLAY_GOLDEN)
    cfg, ecfg = replay.amnesia_raft_config()
    wl = raft.workload(cfg)
    seconds = {}

    _peak_reset(dev)
    a = engine_steps_run(dev, lambda: core.run_sweep(wl, ecfg, np.arange(seeds), device=dev))
    seconds["a"] = a["wall"]
    vio = [int(v) for v in replay.violation_seeds(a["out"])]
    lanes = min(seeds, REPLAY_GOLDEN_LANES)
    want = [v for v in golden["violating"] if v < lanes]
    if [v for v in vio if v < lanes] != want:
        raise SystemExit(f"violating seeds among lanes 0-{lanes - 1}: {vio[:16]} != {want}")
    events = int(a["out"].ctr.sum())
    log(_rates("phase 17 (a) amnesia sweep", seeds, events, a["wall"], a["calls"],
               a["launches"], dev) + f"; {len(vio)} violating seeds, lanes 0-{lanes - 1} "
        f"= golden {want}; {card}")
    del a["out"]

    seed = vio[1]
    if seed != golden["seed"]:
        raise SystemExit(f"second violating seed {seed} != golden {golden['seed']}")
    t = time.perf_counter()
    b = engine_steps_run(dev, lambda: core.run_traced(wl, ecfg, seed, device=dev))
    _same_replay(b["out"], core.run_traced(wl, ecfg, seed, device="cpu"), dev, "phase 17 (b)")
    seconds["b"] = time.perf_counter() - t
    single, trace = b["out"]
    if not bool(single.wstate.violation):
        raise SystemExit(f"phase 17 (b): the replay of seed {seed} latched no violation")
    plan = replay.extract_fault_schedule(trace, raft.K_FAULT)
    compiled = faults.compile_host(raft.fault_spec(cfg), cfg.num_nodes, seed)
    if plan != compiled or [list(e) for e in plan] != golden["plan"]:
        raise SystemExit(f"phase 17 (b): plan {plan} != compile_host {compiled} or the golden")
    log(f"phase 17 (b) run_traced of seed {seed} on {dev.type} (with the CPU's, "
        f"{seconds['b']:.6f} s; the card's {b['wall']:.6f} s, {b['replay_steps']} one-lane "
        f"steps, {b['launches']} pop_min launches) = the CPU's on every trace key and final "
        f"leaf; plan ({len(plan)} events) = compile_host = golden; {card}")

    t = time.perf_counter()
    result = replay_on_host(replay, raft_host, plan, cfg.num_nodes)
    seconds["c"] = time.perf_counter() - t
    if result is None:
        raise SystemExit("phase 17 (c): the violation did not reproduce on the host tier")
    got = host_result(result)
    if got != golden["host"]:
        raise SystemExit(f"phase 17 (c): {got} != golden {golden['host']}")
    host_runs = got["host_seed"] + 1
    log(f"phase 17 (c) replay_on_host ({host_loop()}): reproduced at host seed "
        f"{got['host_seed']} "
        f"({host_runs} host seeds in {seconds['c']:.6f} s, "
        f"{host_runs / seconds['c']:.3f} host seeds/s), {got['violations']} violation(s), "
        f"{got['leaders_elected']} leaders, {got['msgs']} msgs, history sha256 "
        f"{got['history_sha256'][:16]}... = golden; {card}")
    log(f"phase 17 seconds: {json.dumps({k: round(v, 6) for k, v in seconds.items()})}; {card}")
    return {"launches": a["launches"] + b["launches"], "steps": a["calls"] + b["replay_steps"],
            "seconds": seconds, "host": got}


def phase_explore(dev, steer=STEER_RUNS[0], fleet=FLEET_RUNS[0], diff=DIFF_RUNS[0],
                  grid=DIFF_GRID_RUNS[0], card: str = "") -> dict:
    """Phase 16: the steered campaign (a), the fleet drill (b) and the
    differential (c); launches summed over all three."""
    parts = {"steer": phase_steer(dev, steer), "fleet": phase_fleet(dev, fleet),
             "differential": phase_differential(dev, diff, grid, card=card)}
    return dict(parts, launches=sum(p["launches"] for p in parts.values()),
                steps=sum(p["steps"] for p in parts.values()))


def host_fold(plans, num_nodes: int, sim_seconds: float, seed0: int = 0) -> dict:
    """The differential's host half (``explore.differential.host_outcomes``)
    over fault plans compiled beforehand, importing no torch: the port's
    raft example once per seed (``seed0 + i`` under ``plans[i]``),
    hard-stopped at ``sim_seconds``, each history checked against
    ``ElectionSpec``; the outcome as ``TierOutcome``'s fields."""
    from madsim_tpu_torch.examples import raft_host
    from madsim_tpu_torch.oracle import ElectionSpec, check_history

    espec = ElectionSpec()
    elected = no_leader = violating = total = rejects = mismatches = 0
    for i, plan in enumerate(plans):
        out = raft_host.run_seed_with_plan(seed0 + i, [tuple(e) for e in plan], n=num_nodes,
                                           sim_seconds=sim_seconds, extend=False)
        n_elec = out["leaders_elected"]
        total += n_elec
        elected += n_elec > 0
        no_leader += n_elec == 0
        vio = out["violations"] > 0
        violating += vio
        bad = not check_history(out["history"], espec).ok
        rejects += bad
        mismatches += bad != vio
    return {"elected_seeds": elected, "no_leader_seeds": no_leader,
            "violation_seeds": violating, "elections_total": total, "commits_total": 0,
            "hist_reject_seeds": rejects, "hist_mismatch_seeds": mismatches,
            "hist_overflow_seeds": 0, "overflow_seeds": 0}


def host_child(path: str) -> int:
    """Phase 18 (a)'s second run, in a fresh interpreter started under
    ``MADSIM_NO_NATIVE=1``: ``host_fold`` over the plans in ``path``,
    timed, printed as JSON with whether the compiled core loaded and
    whether torch was imported (neither may be)."""
    with open(path) as f:
        job = json.load(f)
    t = time.perf_counter()
    outcome = host_fold(job["plans"], job["num_nodes"], job["sim_seconds"], job["seed0"])
    seconds = time.perf_counter() - t
    core = sys.modules["madsim_tpu_torch.time"]._simloop is not None
    print(json.dumps({"outcome": outcome, "seconds": seconds, "core": core,
                      "torch": "torch" in sys.modules}))
    return 0


def shim_programs():
    """``tests/_torch_shim_programs.py``: the shim programs of the port's
    parity tests, which import neither package."""
    tests = os.path.join(HERE, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import _torch_shim_programs

    return _torch_shim_programs


def phase_native(dev, host=NATIVE_HOST_RUNS[0], lanes: int = NATIVE_DRAW_LANES[0],
                 shim_seeds: int = SHIM_RUNS[0], card: str = "") -> dict:
    """Phase 18, the host tier on its compiled core: (a) the differential's
    first gate spec over ``host`` host seeds on the core and, in a fresh
    interpreter, without it, both equal to ``differential_host.json``; (b)
    ``rng.event_bits`` of ``lanes`` seed keys on ``dev`` equal word for
    word to the native threefry; (c) the shim programs over
    ``shim_seeds`` seeds equal to ``host_shims.json``."""
    import tempfile

    import torch

    import madsim_tpu_torch as ms
    from madsim_tpu_torch import explore, faults, native
    from madsim_tpu_torch.engine import rng
    from madsim_tpu_torch.explore import differential

    if ms.time._simloop is None or ms.time._simloop is not native.simloop():
        raise SystemExit(f"phase 18: the host tier is not on its compiled core: "
                         f"{native.build_error()}")
    seconds, out = {}, {}

    # (a) host seeds/s on the core and in pure Python
    spec = differential.gate_specs()[0]
    dcfg = diff_config(explore, host)
    want = load_golden(DIFF_HOST_GOLDEN)["host"][differential.host_key(spec, dcfg)]
    seeds = range(dcfg.seed0, dcfg.seed0 + dcfg.seeds)
    t0 = time.perf_counter()
    plans = [faults.compile_host(spec, dcfg.num_nodes, s) for s in seeds]
    compile_s = time.perf_counter() - t0
    t = time.perf_counter()
    on_core = host_fold(plans, dcfg.num_nodes, dcfg.sim_seconds, dcfg.seed0)
    core_s = time.perf_counter() - t
    if on_core != want:
        raise SystemExit(f"phase 18 (a) on the core: {on_core} != {DIFF_HOST_GOLDEN}: {want}")
    with tempfile.TemporaryDirectory(dir=_build_dir()) as d:
        path = os.path.join(d, "plans.json")
        with open(path, "w") as f:
            json.dump({"plans": plans, "num_nodes": dcfg.num_nodes,
                       "sim_seconds": dcfg.sim_seconds, "seed0": dcfg.seed0}, f)
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c",
             "import sys, chip_smoke; sys.exit(chip_smoke.host_child(sys.argv[1]))", path],
            cwd=HERE, env=dict(os.environ, MADSIM_NO_NATIVE="1"), capture_output=True,
            text=True, timeout=900)
        child_wall = time.perf_counter() - t
    if proc.returncode != 0:
        raise SystemExit(f"phase 18 (a): the MADSIM_NO_NATIVE=1 child failed:\n{proc.stderr}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    if child["core"] or child["torch"]:
        raise SystemExit(f"phase 18 (a): the child loaded the core or torch: {child}")
    if child["outcome"] != want:
        raise SystemExit(f"phase 18 (a) without the core: {child['outcome']} != {want}")
    n = len(plans)
    out["core_seeds_per_s"] = n / core_s
    out["python_seeds_per_s"] = n / child["seconds"]
    seconds["a"] = time.perf_counter() - t0
    log(f"phase 18 (a) {n} host seeds of gate_specs()[0] ({diff_key(host)}), = "
        f"{DIFF_HOST_GOLDEN} both ways: compiled core {core_s:.6f} s, "
        f"{out['core_seeds_per_s']:.3f} host seeds/s; pure Python (MADSIM_NO_NATIVE=1, fresh "
        f"interpreter, no torch) {child['seconds']:.6f} s, {out['python_seeds_per_s']:.3f} host "
        f"seeds/s (child wall {child_wall:.3f} s); core / Python = "
        f"{out['core_seeds_per_s'] / out['python_seeds_per_s']:.3f}; plans compiled in "
        f"{compile_s:.6f} s; {card}")

    # (b) the device draw stream replayed natively
    t0 = time.perf_counter()
    keys = rng.seed_key(torch.arange(lanes, dtype=torch.int64, device=dev))
    words = {}
    for ctr in NATIVE_CTRS:
        ctrs = torch.full((lanes,), ctr, dtype=torch.int64, device=dev)
        words[ctr] = rng.event_bits(keys, ctrs, NATIVE_DRAW_WORDS).cpu().tolist()
    dev_s = time.perf_counter() - t0
    t = time.perf_counter()
    bad = []
    for ctr in NATIVE_CTRS:
        for s in range(lanes):
            k = native.fold_in((s >> 32) & 0xFFFFFFFF, s & 0xFFFFFFFF, ctr)
            if native.random_bits(k[0], k[1], NATIVE_DRAW_WORDS) != words[ctr][s]:
                bad.append((s, ctr))
    host_s = time.perf_counter() - t
    if bad:
        raise SystemExit(f"phase 18 (b): {len(bad)} (seed, ctr) draw rows differ, first {bad[:4]}")
    out["draw_words"] = lanes * len(NATIVE_CTRS) * NATIVE_DRAW_WORDS
    seconds["b"] = time.perf_counter() - t0
    log(f"phase 18 (b) rng.event_bits on {dev.type} of {lanes} seed keys at counters "
        f"{list(NATIVE_CTRS)}, {NATIVE_DRAW_WORDS} words each: all {out['draw_words']} words "
        f"= native.fold_in + threefry2x32_batch ({dev.type} {dev_s:.6f} s with the copy out, "
        f"native {host_s:.6f} s)")

    # (c) the shims on the core
    shims = shim_programs()
    golden = load_golden(SHIMS_GOLDEN)[f"seeds={shim_seeds}"]
    t = time.perf_counter()
    got = {name: shims.digest(ms, program, shim_seeds) for name, program in shims.SMOKE.items()}
    seconds["c"] = time.perf_counter() - t
    wrong = sorted(name for name in golden if got.get(name) != golden[name])
    if wrong or sorted(got) != sorted(golden):
        raise SystemExit(f"phase 18 (c): {wrong or sorted(got)} != {SHIMS_GOLDEN}")
    runs = len(got) * shim_seeds
    out["programs_per_s"] = runs / seconds["c"]
    log(f"phase 18 (c) {len(got)} shim programs ({', '.join(got)}) x {shim_seeds} seeds on the "
        f"compiled core: logs, draws, virtual ns and outputs = {SHIMS_GOLDEN}; {runs} runs in "
        f"{seconds['c']:.6f} s, {out['programs_per_s']:.3f} programs/s; {card}")
    log(f"phase 18 seconds: {json.dumps({k: round(v, 6) for k, v in seconds.items()})}")
    return dict(out, seconds=seconds, shims=got)


def event_mix_key(run: dict) -> str:
    return f"seeds={run['seeds']},chunk={run['chunk']},horizon_ns={run['time_limit_ns']}"


def event_mix_path(run: dict):
    """Phase 19 (c)'s raft cell: the flagship's config with the event-mix
    plane on (``RaftConfig(num_nodes=5, crashes=1, event_mix=True)``,
    queue 64), at ``run``'s horizon."""
    from madsim_tpu_torch.models import raft

    cfg = raft.RaftConfig(num_nodes=5, crashes=1, event_mix=True)
    return raft.workload(cfg), raft.engine_config(
        cfg, queue_capacity=CAPACITY, time_limit_ns=run["time_limit_ns"], max_steps=MAX_STEPS)


def real_programs():
    """``tests/_torch_real_programs.py``: the real-mode programs of the
    port's parity tests, which import neither package."""
    shim_programs()  # puts tests/ on the path
    import _torch_real_programs

    return _torch_real_programs


def _scraper(url: str, every_s: float = 0.25):
    """A thread scraping ``url`` every ``every_s`` until its ``stop()``,
    which takes one last scrape and returns every body read. Each scrape
    renders the registry under the interpreter lock that the host-paced
    step loop needs, so the interval is a Prometheus-like slow one."""
    import threading
    import urllib.request

    bodies, errors, halt = [], [], threading.Event()

    def run():
        try:
            while True:
                last = halt.wait(every_s)
                with urllib.request.urlopen(url, timeout=10) as r:
                    bodies.append(r.read().decode())
                if last:
                    return
        except OSError as e:
            errors.append(e)

    thread = threading.Thread(target=run, name="phase19-scrape", daemon=True)
    thread.start()

    def stop() -> list:
        halt.set()
        thread.join(timeout=30)
        if thread.is_alive() or errors or not bodies:
            raise SystemExit(f"phase 19 (a): the metrics endpoint did not answer the scraper: "
                             f"{errors or 'no answer'}")
        return bodies

    return stop


def _span(events: list, name: str) -> dict:
    found = [e for e in events if e.get("ph") == "X" and e["name"] == name]
    if not found:
        raise SystemExit(f"phase 19: no trace span {name!r}")
    return found[0]


def phase_obs(dev, stale=STALE_RUNS[0], mix=EVENT_MIX_RUNS[0], workers: int = CHECK_WORKERS,
              reps: int = REAL_REPS[0], off_wall_s=None, card: str = "") -> dict:
    """Phase 19, the telemetry plane on the card and the real-mode twin on
    the chip machine's CPU: one ``obs.Telemetry`` handle (journal, trace
    and a localhost ``/metrics`` endpoint) through (a) phase 9 (b)'s
    stale-read cell on the pipelined checked sweep, (b) the same cell on
    ``driver="stream"`` and (c) the raft sweep with the event-mix plane;
    then (d) the real-mode programs over localhost."""
    import shutil

    import numpy as np

    import madsim_tpu_torch as ms
    from madsim_tpu_torch import obs
    from madsim_tpu_torch.engine import checkpoint, stream
    from madsim_tpu_torch.models import etcd, raft
    from madsim_tpu_torch.oracle import check, screen

    seconds, out = {}, {}
    launches = steps = 0
    root = os.path.join(_build_dir(), "phase19")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    jpath, tpath = os.path.join(root, "journal.jsonl"), os.path.join(root, "trace.json")
    tel = obs.Telemetry(journal=jpath, trace=tpath, http_port=0)

    def kinds() -> list:
        return [r["kind"] for r in obs.read_journal(jpath)]

    # (a) the pipelined checked sweep, scraped from a thread meanwhile
    t0 = time.perf_counter()
    wl, ecfg = etcd_path(stale=True)
    n, chunk = stale
    seeds = np.arange(n, dtype=np.int64)
    spec = etcd.history_spec()
    with open(golden_path(True)) as f:
        golden = json.load(f)["reports"][run_key(n, chunk)]
    stop = _scraper(tel.server.url)
    rep, calls, got, wall = main_path_run(dev, lambda: screen.checked_sweep(
        wl, ecfg, seeds, spec, etcd.sweep_summary, chunk_size=chunk, workers=workers,
        device=dev, telemetry=tel))
    bodies = stop()
    launches, steps = launches + got, steps + calls
    _same_report(rep, golden, "phase 19 (a): stale-read report with telemetry vs golden")
    chunks = -(-n // chunk)
    if kinds() != ["run_start"] + ["chunk"] * chunks:
        raise SystemExit(f"phase 19 (a): journal kinds {kinds()}")
    need = [f"sweep_chunks_total {chunks}", f"sweep_seeds_done_total {n}",
            "# TYPE oracle_screened_total counter", "# TYPE sweep_chunk_seconds histogram"]
    missing = [line for line in need if line not in bodies[-1]]
    if missing:
        raise SystemExit(f"phase 19 (a): the last scrape lacks {missing}")
    out["a"] = {"wall_s": wall, "scrapes": len(bodies), "report": rep}
    seconds["a"] = time.perf_counter() - t0
    log(f"phase 19 (a) stale-read checked sweep with telemetry on (journal, trace, /metrics on "
        f"{tel.server.url}): {n} seeds in {chunks} chunks of {chunk}, report = golden, "
        f"{calls} step_batch calls, {got} pop_min launches; wall {wall:.6f} s with telemetry "
        f"on, phase 9 (b)'s {off_wall_s if off_wall_s is None else f'{off_wall_s:.6f}'} s with "
        f"no handle (a timing stub); journal {chunks} chunk events under run {tel.run_id}; "
        f"{len(bodies)} scrapes from a thread, the last naming the chunk counters; {card}")

    # (b) the same cell through the stream, its rounds counted
    t0 = time.perf_counter()
    rounds = [0]
    inner = stream._round

    def counted(*args, **kwargs):
        rounds[0] += 1
        return inner(*args, **kwargs)

    before = tel.registry.get("stream_rounds_total") or 0
    stream._round = counted
    try:
        rep_b, calls, got, wall_b = main_path_run(dev, lambda: screen.checked_sweep(
            wl, ecfg, seeds, spec, etcd.sweep_summary, chunk_size=chunk, workers=workers,
            driver="stream", device=dev, telemetry=tel))
    finally:
        stream._round = inner
    launches, steps = launches + got, steps + calls
    check.shutdown_pools()
    _same_report(rep_b, rep, "phase 19 (b): the stream's report vs (a)'s")
    counted_rounds = (tel.registry.get("stream_rounds_total") or 0) - before
    if counted_rounds != rounds[0] or rounds[0] <= 0:
        raise SystemExit(f"phase 19 (b): stream_rounds_total {counted_rounds} != the driver's "
                         f"{rounds[0]} rounds")
    if kinds()[1 + chunks:] != ["flush"] * chunks:
        raise SystemExit(f"phase 19 (b): journal kinds {kinds()}")
    out["b"] = {"wall_s": wall_b, "rounds": rounds[0]}
    seconds["b"] = time.perf_counter() - t0
    log(f"phase 19 (b) the same cell on driver='stream' (pool = chunk = {chunk}): report = "
        f"(a)'s, {rounds[0]} rounds = stream_rounds_total, {calls} step_batch calls, {got} "
        f"pop_min launches, wall {wall_b:.6f} s, occupancy gauge "
        f"{tel.registry.get('stream_occupancy')}")

    # (c) the event-mix plane on the flagship raft config
    t0 = time.perf_counter()
    wl_m, ecfg_m = event_mix_path(mix)
    rep_c, calls, got, wall_c = main_path_run(dev, lambda: checkpoint.run_sweep_pipelined(
        wl_m, ecfg_m, np.arange(mix["seeds"], dtype=np.int64), raft.sweep_summary,
        chunk_size=mix["chunk"], device=dev, telemetry=tel))
    launches, steps = launches + got, steps + calls
    want = load_golden(EVENT_MIX_GOLDEN)["runs"][event_mix_key(mix)]
    if json.dumps(rep_c, sort_keys=True) != want:
        raise SystemExit(f"phase 19 (c): event-mix report {json.dumps(rep_c, sort_keys=True)} "
                         f"!= {EVENT_MIX_GOLDEN}: {want}")
    mix_counts = rep_c["event_mix"]
    by_kind = [tel.registry.get("engine_events_by_kind_total", kind=str(k))
               for k in range(len(mix_counts))]
    if by_kind != [float(v) for v in mix_counts] or sum(mix_counts) <= 0:
        raise SystemExit(f"phase 19 (c): engine_events_by_kind_total {by_kind} != event_mix "
                         f"{mix_counts}")
    out["c"] = {"wall_s": wall_c, "event_mix": mix_counts}
    seconds["c"] = time.perf_counter() - t0
    log(f"phase 19 (c) raft with the event-mix plane ({event_mix_key(mix)}): report = "
        f"{EVENT_MIX_GOLDEN}, engine_events_by_kind_total = event_mix {mix_counts}; "
        f"{_rates('event mix', mix['seeds'], rep_c['events_total'], wall_c, calls, got, dev)}")

    tel.close()
    with open(tpath) as f:
        events = json.load(f)["traceEvents"]
    tracks = {e["args"]["name"] for e in events if e["ph"] == "M" and e["name"] == "thread_name"}
    if not {"device", "host"} <= tracks:
        raise SystemExit(f"phase 19: trace tracks {sorted(tracks)}")
    dev_span, host_span = _span(events, f"device chunk lo={chunk}"), _span(events, "host check lo=0")
    overlap_us = (min(dev_span["ts"] + dev_span["dur"], host_span["ts"] + host_span["dur"])
                  - max(dev_span["ts"], host_span["ts"]))
    if overlap_us <= 0:
        raise SystemExit("phase 19 (a): the trace's device span of chunk 1 does not overlap the "
                         "host check of chunk 0")
    samples = sum(1 for e in events if e["ph"] == "C" and e["name"] == "stream occupancy")
    if samples != rounds[0]:
        raise SystemExit(f"phase 19 (b): {samples} occupancy samples in the trace != "
                         f"{rounds[0]} rounds")
    records = obs.read_journal(jpath)
    mix_chunks = -(-mix["seeds"] // mix["chunk"])
    if ([r["kind"] for r in records] != ["run_start"] + ["chunk"] * chunks + ["flush"] * chunks
            + ["chunk"] * mix_chunks + ["run_end"] or {r["run"] for r in records} != {tel.run_id}):
        raise SystemExit(f"phase 19: journal {[(r['kind'], r['run']) for r in records]}")
    out["overlap_us"] = overlap_us
    log(f"phase 19 trace: tracks {sorted(tracks)}; chunk 1's device span ({dev_span['dur']:.1f} "
        f"us, dispatch to summary) holds chunk 0's host check ({host_span['dur']:.1f} us): "
        f"{overlap_us:.1f} us in common; {samples} stream occupancy samples; journal "
        f"{len(records)} records, all under run {tel.run_id}")

    # (d) the real-mode twin over localhost
    t0 = time.perf_counter()
    programs = real_programs()
    golden = load_golden(REAL_GOLDEN)
    ran = {}
    for name, program in programs.SMOKE.items():
        t = time.perf_counter()
        digests = {programs.digest(program(ms)) for _ in range(reps)}
        ran[name] = {"runs": reps, "seconds": time.perf_counter() - t}
        if digests != {golden[name]}:
            raise SystemExit(f"phase 19 (d): {name}'s outcome {sorted(digests)} != "
                             f"{REAL_GOLDEN}: {golden[name]}")
    out["d"] = ran
    seconds["d"] = time.perf_counter() - t0
    log("phase 19 (d) real-mode programs over localhost, outcomes = " + REAL_GOLDEN + ": "
        + "; ".join(f"{k} {v['runs']} runs {v['seconds']:.6f} s" for k, v in ran.items()))
    log(f"phase 19 seconds: {json.dumps({k: round(v, 6) for k, v in seconds.items()})}")
    shutil.rmtree(root, ignore_errors=True)
    return dict(out, launches=launches, steps=steps, seconds=seconds)


def wire_programs():
    """``tests/_torch_wire.py``: the wire programs of the port's parity
    tests, which import neither package."""
    shim_programs()  # puts tests/ on the path
    import _torch_wire

    return _torch_wire


def _wire_legs(slo: dict) -> str:
    """Each wire's p50/p99 per api, method or op from the rig's report."""
    out = []
    for wire, hist in (("kafka", "kafka_api_seconds"), ("s3", "s3_api_seconds"),
                       ("etcd", "etcd_api_seconds")):
        legs = slo.get(hist, {})
        out.append(f"{wire}: " + ", ".join(
            f"{k} n={v['count']} p50 {v['p50_ms']} ms p99 {v['p99_ms']} ms"
            for k, v in sorted(legs.items())))
    return "; ".join(out)


def phase_wire(dev, smoke: bool = True, card: str = "") -> dict:
    """Phase 20: the wire rig on this machine's CPU (see the module
    docstring); returns the seconds of each leg, the smoke rig's report
    and pop_min's launches (0). ``smoke=False`` leaves out leg (c), the
    smoke rig's subprocess (the CPU rehearsal runs it only under
    ``-m slow``)."""
    import tempfile

    import madsim_tpu_torch as ms

    wires = wire_programs()
    seconds, out = {}, {}

    def run():
        # (a) the determinism reports, every variant byte-equal to the golden
        t0 = time.perf_counter()
        golden = load_golden(WIRE_DET_GOLDEN)
        runs = 0
        for seed in WIRE_DET_SEEDS:
            want = wires.report_bytes(golden[str(seed)])
            for kind in ("async", "legacy"):
                for telemetry in (True, False):
                    got = wires.determinism_bytes(ms, kind, seed, telemetry)
                    if got != want:
                        raise SystemExit(f"phase 20 (a): seed {seed}, {kind}, telemetry "
                                         f"{telemetry}: report {got!r} != {WIRE_DET_GOLDEN}")
                    report = json.loads(got)
                    if not (report["kafka"]["replay_ok"] and report["s3"]["replay_ok"]):
                        raise SystemExit(f"phase 20 (a): seed {seed}, {kind}: a replay failed")
                    runs += 1
        seconds["a"] = time.perf_counter() - t0
        out["a"] = {"reports": runs}
        log(f"phase 20 (a) wire_load determinism: {runs} reports (seeds {list(WIRE_DET_SEEDS)} x "
            f"async/legacy x telemetry on/off) = {WIRE_DET_GOLDEN}, replays ok, "
            f"{seconds['a']:.6f} s")

        # (b) the Kafka wire-vs-broker differential's digests
        t0 = time.perf_counter()
        fuzz = load_golden(FUZZ_GOLDEN)
        for leg, digests in (("loopback", wires.fuzz_digests), ("tcp", wires.fuzz_tcp_digests)):
            want = fuzz[leg]
            got = digests(ms, want["seeds"], want["ops"])
            if got != want["digests"]:
                bad = [s for s, g, w in zip(want["seeds"], got, want["digests"]) if g != w]
                raise SystemExit(f"phase 20 (b): {leg} fuzz digests of seeds {bad} != "
                                 f"{FUZZ_GOLDEN}")
        seconds["b"] = time.perf_counter() - t0
        out["b"] = {leg: len(fuzz[leg]["seeds"]) for leg in ("loopback", "tcp")}
        log(f"phase 20 (b) kafka fuzz: {out['b']['loopback']} seeds on loopback at "
            f"{fuzz['loopback']['ops']} ops and {out['b']['tcp']} over localhost TCP at "
            f"{fuzz['tcp']['ops']} ops = {FUZZ_GOLDEN}, {seconds['b']:.6f} s")

        # (c) the smoke rig in a fresh interpreter: it forks its workers
        if not smoke:
            return
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "smoke.json")
            env = dict(os.environ, PYTHONPATH=HERE)
            proc = subprocess.run(
                [sys.executable, "-m", "madsim_tpu_torch.wire_load", "--smoke", "--report", path],
                cwd=HERE, env=env, capture_output=True, text=True, timeout=WIRE_SMOKE_TIMEOUT_S)
            if proc.returncode != 0 or not os.path.exists(path):
                raise SystemExit(f"phase 20 (c): wire_load --smoke exited {proc.returncode}:\n"
                                 f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
            with open(path) as f:
                rig = json.load(f)
        seconds["c"] = time.perf_counter() - t0
        load = rig["load"]
        if load["gate_failures"] or not rig["parity"]:
            raise SystemExit(f"phase 20 (c): gate {load['gate_failures']}, parity {rig['parity']}")
        out["c"] = rig
        log(f"phase 20 (c) smoke rig on this machine's CPU{card}: {load['clients']} clients in "
            f"{load['workers']} worker processes, {load['total_ops']} ops in "
            f"{load['elapsed_s']} s, {load['throughput_ops_s']} ops/s, peak "
            f"{load['peak_open_conns']} connections, errors {load['stats']['errors']}, "
            f"chaos {json.dumps(load['chaos'], sort_keys=True)}, histories "
            f"{json.dumps(load['history_checks'], sort_keys=True)}, replay "
            f"{json.dumps(load['replay'], sort_keys=True)}, gate ok, async-vs-legacy parity ok; "
            f"subprocess {seconds['c']:.6f} s")
        log(f"phase 20 (c) p50/p99 (server-side histograms){card}: {_wire_legs(load['slo'])}")

    r = engine_steps_run(dev, run)
    if r["launches"] != 0 or r["calls"] != 0:
        raise SystemExit(f"phase 20: pop_min launched {r['launches']} times "
                         f"({r['calls']} step_batch calls): the wire rig touched the card")
    log(f"phase 20 seconds: {json.dumps({k: round(v, 6) for k, v in seconds.items()})}; "
        f"pop_min launches 0")
    return dict(out, launches=r["launches"], seconds=seconds)


def npz_record(path: str) -> dict:
    """Every array of an ``.npz`` by name: dtype, shape and sha256; and
    the archive's sha256."""
    import hashlib

    import numpy as np

    arrays = {}
    with np.load(path) as z:
        for k in z.files:
            a = z[k]
            arrays[k] = [str(a.dtype), list(a.shape),
                         hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()]
    with open(path, "rb") as f:
        return {"arrays": arrays, "sha256": hashlib.sha256(f.read()).hexdigest()}


def _script(module: str, *args: str, env=None) -> subprocess.CompletedProcess:
    """``python -m madsim_tpu_torch.scripts.<module> *args`` in a fresh
    interpreter from this checkout; a nonzero exit stops the phase."""
    proc = subprocess.run(
        [sys.executable, "-m", f"madsim_tpu_torch.scripts.{module}", *args],
        cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE, **(env or {})),
        capture_output=True, text=True, timeout=SCRIPT_TIMEOUT_S)
    if proc.returncode != 0:
        raise SystemExit(f"phase 21: {module} {' '.join(args)} exited {proc.returncode}:\n"
                         f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return proc


# sweep_million's line: what equals the reference's (backend and the
# compile count measure each package's own device and compiler)
SWEEP_LINE_KEYS = ("metric", "seeds", "chunk_size", "violations", "elections_total",
                   "chunks_loaded_from_checkpoint", "chunks_computed", "mesh_devices")


def phase_scripts(dev, sweep=SCRIPT_SWEEP_RUNS[0], card: str = "") -> dict:
    """Phase 21: the command-line drivers on ``dev`` by their documented
    commands (see the module docstring); returns the seconds of each leg,
    the engine steps and pop_min's launches (the dump's processes'
    included)."""
    import contextlib
    import io
    import tempfile

    from madsim_tpu_torch.scripts import sweep_million

    golden = load_golden(SCRIPTS_GOLDEN)
    total, chunk = sweep
    want = golden["sweep_million"][f"{total}/{chunk}"]
    env = {"MADSIM_SWEEP_CHUNK": str(chunk), "MADSIM_HB_SECONDS": "0"}
    # the CPU rehearsal's processes run one torch thread each: an eager
    # step is hundreds of small ops, which extra threads only slow down
    sub_env = {"OMP_NUM_THREADS": "1"} if dev.type == "cpu" else {}
    seconds, out = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the sweep in this process, its steps and launches counted,
        # then the same command as a fresh process over its checkpoints
        ck = os.path.join(tmp, "ck")
        argv = [str(total), ck, "--device", dev.type]
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                r = engine_steps_run(dev, lambda: sweep_million.main(argv))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        first = json.loads(buf.getvalue().splitlines()[-1])
        seconds["a_first"] = r["wall"]
        chunks = {}
        for name in sorted(os.listdir(ck)):
            with open(os.path.join(ck, name)) as f:
                chunks[name] = json.load(f)["summary"]
        if chunks != want["chunks"]:
            raise SystemExit(f"phase 21 (a): chunk summaries {chunks} != {SCRIPTS_GOLDEN}'s "
                             f"{want['chunks']}")
        for key in SWEEP_LINE_KEYS:
            if first[key] != want["line"][key]:
                raise SystemExit(f"phase 21 (a): {key} {first[key]} != the reference's "
                                 f"{want['line'][key]}")
        if first["compiles_in_timed_region"] != 0 or first["chunks_computed"] != len(chunks):
            raise SystemExit(f"phase 21 (a): {first}")
        t0 = time.perf_counter()
        proc = _script("sweep_million", *argv, env=dict(env, **sub_env))
        seconds["a_resume"] = time.perf_counter() - t0
        second = json.loads(proc.stdout.splitlines()[-1])
        same = ("violations", "elections_total", "seeds", "chunk_size")
        if (second["chunks_computed"], second["chunks_loaded_from_checkpoint"],
                second["compiles_in_timed_region"]) != (0, len(chunks), 0) or \
                any(second[k] != first[k] for k in same):
            raise SystemExit(f"phase 21 (a): the resumed run {second} against {first}")
        out["a"] = {"first": first, "resumed": second, "steps": r["calls"],
                    "launches": r["launches"], "peak": r["peak"]}
        log(f"phase 21 (a) sweep_million {total} (chunks of {chunk}){card}: {r['calls']} "
            f"batched steps = {r['launches']} pop_min launches (the warm-up's steps "
            f"included), wall {first['wall_s']} s in the timed region, "
            f"{first['seeds_per_sec']} seeds/s, {first['events_per_sec']} events/s, "
            f"compiles_in_timed_region 0, violations {first['violations']}, elections "
            f"{first['elections_total']}, chunk summaries = {SCRIPTS_GOLDEN}; {seconds['a_first']:.3f} "
            f"s in all; resumed in a fresh process: {second['chunks_loaded_from_checkpoint']} "
            f"chunks loaded, 0 computed, same totals, {seconds['a_resume']:.3f} s")

        # (b) the gate's dump leg: two fresh processes side by side (each
        # host-paced on a core of its own), equal archives, each array
        # equal to the JAX-made dump
        gate_out = os.path.join(tmp, "gate")
        t0 = time.perf_counter()
        proc = _script("check_determinism", "--legs", "dump", "--device", dev.type,
                       "--out", gate_out, "--jobs", "2", env=sub_env)
        seconds["b"] = time.perf_counter() - t0
        got = npz_record(os.path.join(gate_out, "a.npz"))
        if got["arrays"] != golden["dump"]["arrays"]:
            bad = sorted(k for k in set(got["arrays"]) | set(golden["dump"]["arrays"])
                         if got["arrays"].get(k) != golden["dump"]["arrays"].get(k))
            raise SystemExit(f"phase 21 (b): dump arrays {bad} differ from {SCRIPTS_GOLDEN}")
        dumps = []
        for r_ in "ab":
            with open(os.path.join(gate_out, f"{r_}.dump.log")) as f:
                line = next(ln for ln in f if ln.startswith('{"dump"'))
            d = json.loads(line)["dump"]
            if dev.type == "cuda" and d["pop_min_launches"] != d["engine_steps"]:
                raise SystemExit(f"phase 21 (b): {d}")
            dumps.append(d)
        out["b"] = {"processes": dumps, "same_archive": got["sha256"] == golden["dump"]["sha256"]}
        log(f"phase 21 (b) check_determinism --legs dump{card}: two processes, byte-identical "
            f"archives, {len(got['arrays'])} arrays = {SCRIPTS_GOLDEN} by name, dtype, shape and "
            f"sha256 (the archive's own sha256 {'equal' if out['b']['same_archive'] else 'unequal'}"
            f" too); engine steps = pop_min launches per process "
            f"{[(d['engine_steps'], d['pop_min_launches']) for d in dumps]}; "
            f"{seconds['b']:.3f} s ({proc.stdout.splitlines()[0]})")
    launches = out["a"]["launches"] + sum(d["pop_min_launches"] for d in out["b"]["processes"])
    log(f"phase 21 seconds: {json.dumps({k: round(v, 6) for k, v in seconds.items()})}; "
        f"pop_min launches {launches}")
    return dict(out, launches=launches, seconds=seconds)


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
    # importing the package builds the host tier's compiled core
    # (native/simcore.cpp and simloop.c, into madsim_tpu_torch/_build/native)
    t0 = time.perf_counter()
    import madsim_tpu_torch as ms
    from madsim_tpu_torch import native
    from madsim_tpu_torch.engine import core, cuda_build, cuda_megasweep, cuda_queue

    native_s = time.perf_counter() - t0
    if not native.available() or native.simloop() is None or ms.time._simloop is None:
        print(f"chip_smoke: the host tier's compiled core did not build or load:\n"
              f"{native.build_error()}", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"torch.cuda.device_count() = {torch.cuda.device_count()}")

    clock = sm_clock_hz()
    int32_rate = SMS * ISSUE_LANES_PER_SM * clock
    log(f"SM clock max {clock / 1e6:.0f} MHz: integer issue ceiling {int32_rate:.6e} ops/s")

    # both kernels built together, one nvcc each
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(cuda_queue.build), pool.submit(cuda_megasweep.build)]:
            job.result()
    log(f"built pop_min and megasweep in {time.perf_counter() - t0:.3f} s")
    import sysconfig

    include = sysconfig.get_paths()["include"]
    built = {k: round(v, 3) for k, v in native.BUILD_SECONDS.items()}
    log(f"host core: {built or 'an identical build was loaded'} s of gcc/g++ "
        f"({native.simloop().__file__}; Python.h under {include}: "
        f"{os.path.exists(os.path.join(include, 'Python.h'))}); the import that built it "
        f"took {native_s:.3f} s")
    for name in ("pop_min", "megasweep"):
        log(f"[{name}] " + cuda_build.LOGS.get(name, "(an identical build was loaded)").strip())

    seconds = {}

    def timed(phase: int, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[phase] = time.perf_counter() - t
        log(f"phase {phase}: {seconds[phase]:.3f} s")
        return out

    k = timed(2, phase_kernel, dev)
    k48 = phase_kernel(dev, etcd_queue=True)
    final, launches = timed(3, phase_main_path, dev)
    timed(4, phase_parity, final,
          os.path.join(HERE, "madsim_tpu_torch", "data", "flagship_summary.json"))
    del final
    timed(5, phase_replay, dev)
    mega = timed(6, phase_megasweep, dev, int32_ops_per_s=int32_rate)
    timed(7, phase_ab)
    grid = timed(8, phase_spec_as_data, dev)
    checked = timed(9, phase_checked_sweep, dev)
    kafka_out = timed(10, phase_kafka, dev)
    s3_out = timed(11, phase_s3, dev)
    kafka_checked = timed(12, phase_kafka_checked, dev)
    streamed = timed(13, phase_stream, dev)
    # the ranks of phases 14-15 share the card: this process's step graphs
    # and cached blocks go back to it
    core.release_step_graphs()
    torch.cuda.empty_cache()
    meshed = timed(14, phase_mesh, dev)
    campaigned = timed(15, phase_campaign, dev)
    explored = timed(16, phase_explore, dev, card=f"; {smi}")
    crossed = timed(17, phase_cross_tier, dev, card=smi)
    timed(18, phase_native, dev, card=smi)
    observed = timed(19, phase_obs, dev, off_wall_s=checked["stale_host_decode_wall_s"],
                     card=smi)
    wired = timed(20, phase_wire, dev, card=f" ({smi})")
    scripted = timed(21, phase_scripts, dev, card=f" ({smi})")
    per_phase = {3: launches, 8: grid["launches"], 9: checked["launches"],
                 10: kafka_out["launches"], 11: s3_out["launches"],
                 12: kafka_checked["launches"], 13: streamed["launches"],
                 14: meshed["launches"], 15: campaigned["launches"], 16: explored["launches"],
                 17: crossed["launches"], 19: observed["launches"], 20: wired["launches"],
                 21: scripted["launches"]}
    launches = sum(per_phase.values())
    log(f"pop_min launches per phase (each = its engine steps: step_batch calls, summed over "
        f"the ranks in 14-15 and the workers in 16, and in 16-17 the one-lane replays' steps): "
        f"{json.dumps(per_phase)}; total {launches}")
    log(f"phase seconds: {json.dumps({p: round(t, 3) for p, t in seconds.items()})}")
    profiled = profiled_kernels_ms([("pop_min_kernel", k["launch"], 50),
                                    ("megasweep_kernel", mega["launch"], 5)])
    log(f"profiled kernel durations (one torch.profiler session): {json.dumps(profiled)} ms")

    b_ms, b_by = bound_ms(NUM_SEEDS, CAPACITY, int32_rate)
    b48_ms, b48_by = bound_ms(NUM_SEEDS, k48["capacity"], int32_rate)
    log(f"pop_min at Q={k48['capacity']}: kernel {k48['ms']:.6f} ms vs bound {b48_ms:.6f} ms "
        f"({b48_by}), {b48_ms / k48['ms']:.3f} of the bound")
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
        "ms_q48": k48["ms"],
        "plain_ms_q48": k48["plain_ms"],
        "bound_ms_q48": b48_ms,
        "max_abs_err_q48": k48["max_abs_err"],
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
