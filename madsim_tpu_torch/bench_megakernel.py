"""A/B on the card: the megasweep kernel against the eager engine step.

Run on a CUDA machine from the repository root:

    python3 -m madsim_tpu_torch.bench_megakernel [--batches 4096 16384 65536]

For each batch it builds the probe workload's state (``probe_config``,
seeds 0..batch-1), runs the plain version (``run_megasweep_ref``:
``core.step_batch`` 512 times) once, and holds ``run_megasweep`` to its
final state on every leaf — a difference stops the run. (``tile`` keeps
its default: on the card one launch runs the whole batch whatever it is.)
Then it times both on the card with CUDA events after that warm-up, in
turns (eager, megasweep, twice over, the least of each), and prints one
JSON row per batch: eager us/step, megasweep us/step, their ratio,
``bit_exact`` and the card. The last line is the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from .engine import core, state_io
from .engine.megakernel import probe_config, probe_workload, run_megasweep, run_megasweep_ref

STEPS = 512
BATCHES = (4096, 16384, 65536)
REPS = 2


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _event_ms(fn) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def bench_batch(batch: int) -> dict:
    """One A/B row at ``batch`` seeds (see the module docstring)."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_megakernel measures the card; no CUDA card is available")
    s0 = core.init_sweep(probe_workload(), probe_config(STEPS), torch.arange(batch),
                         device="cuda")
    ref = run_megasweep_ref(s0, STEPS)
    if state_io.first_difference(ref, run_megasweep(s0, STEPS)) is not None:
        raise SystemExit(f"megasweep at batch {batch} differs from the plain version")
    torch.cuda.synchronize()
    times = {"eager": [], "mega": []}
    for _ in range(REPS):
        times["eager"].append(_event_ms(lambda: run_megasweep_ref(s0, STEPS)))
        times["mega"].append(_event_ms(lambda: run_megasweep(s0, STEPS)))
    eager_us = min(times["eager"]) / STEPS * 1e3
    mega_us = min(times["mega"]) / STEPS * 1e3
    return {
        "batch": batch,
        "steps": STEPS,
        "eager_us_per_step": eager_us,
        "mega_us_per_step": mega_us,
        "mega_over_eager": mega_us / eager_us,
        "bit_exact": True,
        "device": torch.cuda.get_device_name(0),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    args = ap.parse_args()
    for batch in args.batches:
        print(json.dumps(bench_batch(batch)), flush=True)
    print(card())


if __name__ == "__main__":
    main()
