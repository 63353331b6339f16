"""The control of a cell's correctness check, on the card at the cell's
own size.

    python3 -m portbench.control --workload <name> --seconds <s> --seeds <n> [<n> ...]

For each seed it runs the cell as the benchmark does (``run.run_cell``),
then puts the control in the program's place on the same lanes: the
plain reference with every clock value and deadline held in 32 bits,
the width below the configuration's int64 nanoseconds (the step that
would halve the queue's time plane). It prints one JSON line a seed, the
program's numbers compared and the control's; the control has to come
out not correct. The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    from portbench import harness, run

    ap = argparse.ArgumentParser(description="Run a cell and its control on the same lanes.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control runs the cell on a CUDA card; none found", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    for seed in args.seeds:
        try:
            line, _ = run.run_cell(bench, args.workload, seed, args.seconds, False,
                                torch.device("cuda", 0), with_control=True,
                                t_start=time.perf_counter())
        finally:
            run.stop_helpers()
        print(json.dumps({
            "seed": seed, "correct": line["correct"], "metrics": line["metrics"],
            "device": line["device"], "compared": line["compared"],
            "control_correct": harness.within_limits(line["control"]),
            "control": line["control"],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
