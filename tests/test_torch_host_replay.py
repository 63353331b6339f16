"""Port parity: the cross-tier replay (``tests/test_replay.py``'s
pipeline) with the port's own host tier, and the golden of
``chip_smoke.py`` phase 17.

1. the amnesia sweep (``replay.amnesia_raft_config()``) over the
   reference test's 160 seeds flags violating seeds — the port at
   ``device="cpu"`` and the reference on JAX's CPU backend;
2. ``run_traced`` of the second violating seed replays it, in both
   packages to equal traces;
3. its fault plan equals ``faults.compile_host`` of the spec;
4. ``replay_on_host`` applies the plan to the host-tier raft example —
   the reference's ``examples/raft_host.py`` on the reference's runtime,
   the port's ``madsim_tpu_torch/examples/raft_host.py`` on the port's —
   and both reproduce the violation with equal counters and history
   bytes.

The reference's result is ``madsim_tpu_torch/data/host_replay.json``,
which this file writes (``JAX_PLATFORMS=cpu python
tests/test_torch_host_replay.py --write``). Beside the pipeline: the raft
example through both packages for seeds 0-15, and the differential's
host half (``host_outcomes``) at ``DifferentialConfig(seeds=16)`` for all
four gate specs.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)
if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import chip_smoke  # noqa: E402
from madsim_tpu import faults as rfaults  # noqa: E402
from madsim_tpu import replay as rreplay  # noqa: E402
from madsim_tpu.engine import core as rcore  # noqa: E402
from madsim_tpu.explore import differential as rdiff  # noqa: E402
from madsim_tpu.models import raft as rraft  # noqa: E402
from madsim_tpu.oracle.history import history_bytes as rbytes  # noqa: E402
from madsim_tpu_torch import faults as pfaults  # noqa: E402
from madsim_tpu_torch import replay as preplay  # noqa: E402
from madsim_tpu_torch.engine import core as pcore  # noqa: E402
from madsim_tpu_torch.examples import raft_host as phost  # noqa: E402
from madsim_tpu_torch.explore import differential as pdiff  # noqa: E402
from madsim_tpu_torch.models import raft as praft  # noqa: E402
from madsim_tpu_torch.oracle.history import history_bytes as pbytes  # noqa: E402
from madsim_tpu_torch.engine import state_io  # noqa: E402

sys.path.insert(0, os.path.join(REPO, "examples"))
import raft_host as rhost  # noqa: E402

from _torch_parity import assert_leaves_equal, ref_leaves  # noqa: E402

LANES = chip_smoke.REPLAY_GOLDEN_LANES


def reference_pipeline(lanes: int = LANES) -> dict:
    """The reference's pipeline, in the golden's layout."""
    cfg, ecfg = rreplay.amnesia_raft_config()
    final = rcore.run_sweep(rraft.workload(cfg), ecfg, jnp.arange(lanes, dtype=jnp.int64))
    vio = [int(v) for v in rreplay.violation_seeds(final)]
    seed = vio[1]
    single, trace = rcore.run_traced(rraft.workload(cfg), ecfg, seed)
    assert bool(single.wstate.violation)
    plan = rreplay.extract_fault_schedule(trace, rraft.K_FAULT)
    assert plan == rfaults.compile_host(rraft.fault_spec(cfg), cfg.num_nodes, seed)
    result = chip_smoke.replay_on_host(rreplay, rhost, plan, cfg.num_nodes)
    return {"lanes": lanes, "violating": vio, "seed": seed,
            "plan": [list(e) for e in plan], "host_seeds": chip_smoke.REPLAY_HOST_SEEDS,
            "host": chip_smoke.host_result(result, rbytes), "summary": rraft.sweep_summary(final),
            "trace": {k: np.asarray(v) for k, v in trace.items()},
            "final": ref_leaves(single)}


def golden_fields(out: dict) -> dict:
    return {k: out[k] for k in ("lanes", "violating", "seed", "plan", "host_seeds", "host")}


@pytest.fixture(scope="module")
def ref_pipeline():
    return reference_pipeline()


def test_pipeline_equals_the_reference_and_the_golden(ref_pipeline):
    cfg, ecfg = preplay.amnesia_raft_config()
    wl = praft.workload(cfg)
    final = pcore.run_sweep(wl, ecfg, np.arange(LANES), device="cpu")
    vio = [int(v) for v in preplay.violation_seeds(final)]
    assert vio == ref_pipeline["violating"]
    assert praft.sweep_summary(final) == ref_pipeline["summary"]
    seed = vio[1]
    single, trace = pcore.run_traced(wl, ecfg, seed, device="cpu")
    assert sorted(trace) == sorted(ref_pipeline["trace"])
    for k, v in trace.items():
        assert np.array_equal(v.numpy(), ref_pipeline["trace"][k]), k
    assert_leaves_equal(ref_pipeline["final"], state_io.to_numpy_leaves(single), "replay")
    plan = preplay.extract_fault_schedule(trace, praft.K_FAULT)
    assert plan == pfaults.compile_host(praft.fault_spec(cfg), cfg.num_nodes, seed)
    assert [list(e) for e in plan] == ref_pipeline["plan"]
    result = chip_smoke.replay_on_host(preplay, phost, plan, cfg.num_nodes)
    assert result is not None and result["violations"] > 0
    assert chip_smoke.host_result(result) == ref_pipeline["host"]
    assert golden_fields(ref_pipeline) == chip_smoke.load_golden(chip_smoke.REPLAY_GOLDEN)


def test_raft_host_equals_the_reference():
    """The raft example through both packages: equal dicts and equal
    history bytes, free-running, under a plan and under a spec."""
    amnesia = rraft.fault_spec(rreplay.amnesia_raft_config()[0])
    for seed in range(16):
        runs = [rhost.run_seed(seed), phost.run_seed(seed)]
        if seed % 4 == 0:
            plan = rfaults.compile_host(amnesia, 3, seed)
            runs += [rhost.run_seed_with_plan(seed, plan, n=3),
                     phost.run_seed_with_plan(seed, plan, n=3)]
        if seed % 4 == 1:
            runs += [rhost.run_seed_with_spec(seed, rdiff.gate_specs()[seed % 3], seed, n=3,
                                              sim_seconds=2.0, extend=False),
                     phost.run_seed_with_spec(seed, pdiff.gate_specs()[seed % 3], seed, n=3,
                                              sim_seconds=2.0, extend=False)]
        for ref, port in zip(runs[::2], runs[1::2]):
            assert rbytes(ref.pop("history")) == pbytes(port.pop("history"))
            assert port == ref


@pytest.mark.parametrize("spec", range(4))
def test_host_outcomes_equal_the_reference(spec):
    """``host_outcomes`` at ``DifferentialConfig(seeds=16)`` against the
    reference's, and at the rehearsal grid against the golden."""
    got = pdiff.host_outcomes(pdiff.gate_specs()[spec], pdiff.DifferentialConfig(seeds=16))
    want = rdiff.host_outcomes(rdiff.gate_specs()[spec], rdiff.DifferentialConfig(seeds=16))
    assert got._asdict() == want._asdict()
    assert all(type(v) is int for v in got)
    dcfg = pdiff.DifferentialConfig(seeds=16, sim_seconds=1.0)
    golden = chip_smoke.load_golden(chip_smoke.DIFF_HOST_GOLDEN)["host"]
    spec_ = pdiff.gate_specs()[spec]
    assert pdiff.host_outcomes(spec_, dcfg)._asdict() == golden[pdiff.host_key(spec_, dcfg)]


def write() -> None:
    out = golden_fields(reference_pipeline())
    path = chip_smoke.data_path(chip_smoke.REPLAY_GOLDEN)
    with open(path, "w") as f:
        f.write(json.dumps(out, indent=1, sort_keys=True) + "\n")
    print(f"wrote {path}: {json.dumps(out['host'])}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        raise SystemExit("usage: JAX_PLATFORMS=cpu python tests/test_torch_host_replay.py --write")
    write()
