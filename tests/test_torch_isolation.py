"""The port stands alone: ``madsim_tpu_torch`` (and ``chip_smoke.py``)
import neither ``jax`` nor anything of ``madsim_tpu``, and its entry
points default to CUDA and refuse to run silently on the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "madsim_tpu_torch")

MODULES = [
    "madsim_tpu_torch",
    "madsim_tpu_torch.engine.rng",
    "madsim_tpu_torch.engine.ops",
    "madsim_tpu_torch.engine.queue",
    "madsim_tpu_torch.engine.cuda_build",
    "madsim_tpu_torch.engine.cuda_queue",
    "madsim_tpu_torch.engine.cuda_megasweep",
    "madsim_tpu_torch.engine.megakernel",
    "madsim_tpu_torch.engine.core",
    "madsim_tpu_torch.engine.net",
    "madsim_tpu_torch.engine.faults",
    "madsim_tpu_torch.engine.state_io",
    "madsim_tpu_torch.engine.tree",
    "madsim_tpu_torch.oracle.history",
    "madsim_tpu_torch.models._common",
    "madsim_tpu_torch.models.raft",
    "madsim_tpu_torch.bench_megakernel",
]


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, not sources
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in MODULES)
        + "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'madsim_tpu' or m.startswith('madsim_tpu.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_imports_jax_or_the_reference(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "madsim_tpu"), (
                f"{os.path.relpath(path, REPO)}:{node.lineno} imports {name}"
            )


def test_entry_points_default_to_cuda_and_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None legitimately runs there")
    from madsim_tpu_torch.engine import core
    from madsim_tpu_torch.models import raft

    cfg = raft.RaftConfig(num_nodes=3, crashes=1)
    wl, ecfg = raft.workload(cfg), raft.engine_config(cfg, max_steps=10)
    for call in (
        lambda: core.run_sweep(wl, ecfg, np.arange(4)),
        lambda: core.init_sweep(wl, ecfg, np.arange(4)),
        lambda: core.run_sweep_chunked(wl, ecfg, np.arange(4), chunk_size=2),
        lambda: core.run_traced(wl, ecfg, 1),
        lambda: core.step_batch(wl, ecfg, core.init_sweep(wl, ecfg, [1], device="cpu")),
        lambda: core.run_sweep(wl, ecfg, np.arange(4), device="cuda"),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_cuda_wrapper_raises_instead_of_falling_back():
    """On a non-CPU, non-CUDA device the wrapper refuses; there is no
    path from a CUDA request to the plain version."""
    from madsim_tpu_torch.engine import cuda_queue

    t = torch.zeros((2, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        cuda_queue.pop_min_decision(t, torch.zeros((2,), dtype=torch.int64, device="meta"))
