"""The golden flagship summary the port checks itself against on the card.

``madsim_tpu_torch/data/flagship_summary.json`` holds the JAX reference's
``sweep_summary`` of the flagship (``RaftConfig(num_nodes=5,
crashes=1)``, queue 64, a 3 s horizon, 200,000 max steps) over seeds
0-63. ``chip_smoke.py`` compares the GPU run's first 64 lanes with it,
where JAX may be absent; this test recomputes it with ``madsim_tpu`` so
the file can never go stale. Regenerate with
``JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write``.
"""

import json
import os
import sys

import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "madsim_tpu_torch", "data", "flagship_summary.json")

CONFIG = {
    "raft": {"num_nodes": 5, "crashes": 1},
    "engine": {"queue_capacity": 64, "time_limit_ns": 3_000_000_000, "max_steps": 200_000},
    "seeds": [0, 64],
}


def reference_summary():
    from madsim_tpu.engine import core
    from madsim_tpu.models import raft

    cfg = raft.RaftConfig(**CONFIG["raft"])
    ecfg = raft.engine_config(cfg, **CONFIG["engine"])
    lo, hi = CONFIG["seeds"]
    final = core.run_sweep(raft.workload(cfg), ecfg, jnp.arange(lo, hi, dtype=jnp.int64))
    return raft.sweep_summary(final)


def test_golden_summary_is_the_reference():
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden["config"] == CONFIG
    assert golden["summary"] == reference_summary()


def test_golden_summary_shape():
    with open(GOLDEN) as f:
        golden = json.load(f)
    s = golden["summary"]
    assert s["seeds"] == 64 and s["overflow_seeds"] == 0
    assert s["events_total"] > 64 * 100 and s["commits_total"] > 0


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_golden.py --write")
    sys.path.insert(0, REPO)
    with open(GOLDEN, "w") as f:
        json.dump({"config": CONFIG, "summary": reference_summary()}, f, indent=1,
                  sort_keys=True)
        f.write("\n")
    print(f"wrote {GOLDEN}")
