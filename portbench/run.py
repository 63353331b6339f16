"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is the entry of ``BENCHMARK.json``'s
``workloads`` named ``--workload``; its configuration, traffic mix, driver
and per-layer metric readers are the files of those names under
``portbench/``. With ``--trace 0`` the result line carries the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, the device's
busy seconds over a profiled sub-window, and a breakdown. The last line of
standard output is the result; the numbers that decided ``correct`` are
the last lines of standard error and the result line's last key.

A run needs a CUDA card and fails without one; ``--lanes`` overrides the
traffic's chunk width (for a chunk-size curve, not for the cells).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import sys  # noqa: E402
from typing import Tuple  # noqa: E402

from portbench import harness  # noqa: E402


def stop_helpers() -> None:
    """Stop the multiprocessing helper processes the checker's pool left
    (its forkserver and resource tracker) and wait for them."""
    from multiprocessing import forkserver, resource_tracker

    for helper in (getattr(forkserver, "_forkserver", None),
                   getattr(resource_tracker, "_resource_tracker", None)):
        stop = getattr(helper, "_stop", None)
        if stop is not None:
            stop()
    for child in multiprocessing.active_children():
        child.join(timeout=30)


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
             lanes: int = 0, pkg: str = harness.PKG, t_start: float = T_START,
             with_control: bool = False) -> Tuple[dict, dict]:
    """One run of cell ``name`` on ``device``; returns the result line's
    object (with the control's reading on the same lanes under
    ``control``, for ``portbench.control``) and the seconds of the run's
    phases. The CPU tests call this with ``device="cpu"``."""
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    ctx = harness.Context(
        config=harness.load_piece("configs", cell["config"], pkg),
        traffic=harness.load_piece("traffic", cell["traffic"], pkg),
        seed=seed, seconds=seconds, trace=trace, device=device, lanes=lanes,
    )
    driver = harness.load_module("drivers", ctx.traffic["driver"], pkg)
    out = driver.run(ctx)
    t_driver = time.perf_counter()
    found = harness.forbidden_modules()
    if found:
        raise SystemExit(f"modules that may not be loaded are: {found}")
    out.end_to_end["setup_s"] = ctx.records["t_open"] - t_start
    compared = dict(out.checks)
    compared.update(harness.compare(ctx.config, out.groups))
    correct = harness.within_limits(compared)
    phases = {
        "setup_s": out.end_to_end["setup_s"],
        "window_s": ctx.records["window"]["wall_s"],
        "after_window_s": t_driver - ctx.records["t_open"] - ctx.records["window"]["wall_s"],
        "reference_s": time.perf_counter() - t_driver,
        "chunks": ctx.records.get("chunks"),
    }
    wanted = harness.cell_metrics(bench, name)
    if trace:
        metrics = harness.read_metrics(wanted["per_layer"], ctx.records, pkg)
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in wanted["end_to_end"]}
    prof = ctx.records.get("profile")
    line = {
        "correct": correct,
        "attempted": int(out.attempted),
        "failed": int(compared["lanes_mismatched"]["value"]),
        "metrics": metrics,
        "device": harness.device_info(device, out.memory_peak_bytes, prof if trace else None),
    }
    if trace and prof is not None:
        line["breakdown"] = harness.breakdown(prof)
    if with_control:
        line["control"] = harness.control(ctx.config, out.groups)
    line["compared"] = compared
    return line, phases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--lanes", type=int, default=0)
    args = ap.parse_args(argv)
    bench = harness.load_benchmark()
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        line, phases = run_cell(bench, args.workload, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda", 0), lanes=args.lanes)
    finally:
        stop_helpers()
    found = harness.forbidden_modules()
    if found:
        print(f"modules that may not be loaded are: {found}", file=sys.stderr)
        return 3
    print("phases " + " ".join(f"{k} {v}" for k, v in phases.items()), file=sys.stderr)
    for k, v in line["compared"].items():
        bound = f"limit {v['limit']}" if "limit" in v else f"min {v['min']}"
        extra = f" {json.dumps(v['leaves'])}" if "leaves" in v else ""
        print(f"{k} {v['value']} {bound}{extra}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
