"""The port stands alone: ``madsim_tpu_torch`` (and ``chip_smoke.py``)
import neither ``jax`` nor anything of ``madsim_tpu`` or ``examples/``,
its host tier imports no torch, and its entry
points (``World``, the steered campaign, the fleet worker and gate and
the differential's device half among them) default to CUDA and refuse to
run silently on the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "madsim_tpu_torch")

# the host tier: numpy only, never torch (it runs in forked procs children
# and in the checker's pool workers)
HOST_MODULES = ["madsim_tpu_torch." + m for m in (
    "rand", "context", "futures", "time", "task", "config", "plugin", "metrics",
    "tracing", "interpose", "runtime", "net", "net.network", "net.netsim", "net.dns",
    "net.ipvs", "net.endpoint", "net.rpc", "net.tcp", "net.udp", "net.unix", "fs",
    "sync", "buggify", "signal", "builder", "faults", "replay", "examples",
    "examples.raft_host", "examples.greeter", "examples.kv_store",
    "native", "tokio",
    "grpc", "grpc.status", "grpc.codec", "grpc.channel", "grpc.server", "grpc.client",
    "grpc.service", "grpc.protogen",
    "etcd", "etcd.service", "etcd.server", "etcd.client",
    "kafka", "kafka.broker", "kafka.server", "kafka.client",
    "s3", "s3.service", "s3.server", "s3.client",
)]

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
    "madsim_tpu_torch.engine.checkpoint",
    "madsim_tpu_torch.engine.stream",
    "madsim_tpu_torch.engine.compiles",
    "madsim_tpu_torch.oracle",
    "madsim_tpu_torch.oracle.history",
    "madsim_tpu_torch.oracle.specs",
    "madsim_tpu_torch.oracle.check",
    "madsim_tpu_torch.oracle.screen",
    "madsim_tpu_torch.models._common",
    "madsim_tpu_torch.models.raft",
    "madsim_tpu_torch.models.etcd",
    "madsim_tpu_torch.models.kafka",
    "madsim_tpu_torch.models.s3",
    "madsim_tpu_torch.models",
    "madsim_tpu_torch.bench_megakernel",
    "madsim_tpu_torch.parallel",
    "madsim_tpu_torch.parallel.mesh",
    "madsim_tpu_torch.parallel.world",
    "madsim_tpu_torch.explore",
    "madsim_tpu_torch.explore.targets",
    "madsim_tpu_torch.explore.triage",
    "madsim_tpu_torch.explore.shrink",
    "madsim_tpu_torch.explore.campaign",
    "madsim_tpu_torch.explore.fleet",
    "madsim_tpu_torch.explore.store",
    "madsim_tpu_torch.explore.steer",
    "madsim_tpu_torch.explore.orchestrator",
    "madsim_tpu_torch.explore.differential",
    "madsim_tpu_torch.entry",
] + HOST_MODULES


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


@pytest.mark.parametrize("module", [
    "madsim_tpu_torch",
    "madsim_tpu_torch.oracle",
    "madsim_tpu_torch.oracle.check",
    "madsim_tpu_torch.oracle.history",
    "madsim_tpu_torch.oracle.specs",
])
def test_the_checkers_modules_import_no_torch(module):
    """The WGL checker's pool workers start as fresh interpreters that
    import ``madsim_tpu_torch.oracle.check``: that import (the package's
    ``__init__`` included) must leave torch out, so a worker stays
    numpy-only."""
    code = (
        f"import sys\nimport {module}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax'))\n"
        "assert not bad, bad[:5]\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_host_tier_imports_no_torch():
    """``import madsim_tpu_torch`` and every host-tier module (the
    runtime, net, fs, builder, faults, the examples, the compiled core,
    the tokio façade and the gRPC, etcd, Kafka and S3 shims) leave torch
    out of ``sys.modules``."""
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in ["madsim_tpu_torch"] + HOST_MODULES)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax'))\n"
        "assert not bad, bad[:5]\n"
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
            assert top not in ("jax", "jaxlib", "madsim_tpu", "examples", "raft_host"), (
                f"{os.path.relpath(path, REPO)}:{node.lineno} imports {name}"
            )


def test_entry_points_default_to_cuda_and_refuse_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None legitimately runs there")
    from madsim_tpu_torch.engine import core
    from madsim_tpu_torch.models import raft

    cfg = raft.RaftConfig(num_nodes=3, crashes=1)
    wl, ecfg = raft.workload(cfg), raft.engine_config(cfg, max_steps=10)
    from madsim_tpu_torch.engine import checkpoint, stream
    from madsim_tpu_torch.oracle import screen

    from madsim_tpu_torch import entry, explore, parallel

    spec = raft.history_spec()
    target, base = explore.amnesia_gate(smoke=True)
    for call in (
        lambda: checkpoint.run_sweep_pipelined(wl, ecfg, np.arange(4), raft.sweep_summary),
        lambda: stream.stream_sweep(wl, ecfg, np.arange(4), raft.sweep_summary, chunk_size=2),
        lambda: screen.checked_sweep(wl, ecfg, np.arange(4), spec, raft.sweep_summary,
                                     driver="stream"),
        lambda: screen.checked_sweep(wl, ecfg, np.arange(4), spec, raft.sweep_summary),
        lambda: screen.screen_history(np.zeros((3, 5), np.int32), np.zeros(3, np.int64), 0, spec),
        lambda: core.run_sweep(wl, ecfg, np.arange(4)),
        lambda: core.init_sweep(wl, ecfg, np.arange(4)),
        lambda: core.run_sweep_chunked(wl, ecfg, np.arange(4), chunk_size=2),
        lambda: core.run_traced(wl, ecfg, 1),
        lambda: core.step_batch(wl, ecfg, core.init_sweep(wl, ecfg, [1], device="cpu")),
        lambda: core.run_sweep(wl, ecfg, np.arange(4), device="cuda"),
        lambda: parallel.run_sweep_sharded(wl, ecfg, np.arange(4)),
        lambda: parallel.seed_mesh(),
        lambda: explore.run_campaign(target, base, explore.CampaignConfig(
            rounds=1, seeds_per_round=4, chunk_size=4)),
        lambda: explore.triage_seed(target, base, 0),
        lambda: entry.entry(),
        lambda: parallel.World(1),
        lambda: explore.run_campaign(target, base, explore.CampaignConfig(
            rounds=1, seeds_per_round=4, chunk_size=4, scheduler="bandit")),
        lambda: explore.run_steered(target, base, explore.CampaignConfig(
            rounds=1, seeds_per_round=4)),
        lambda: explore.run_worker(target, base, explore.CampaignConfig(seeds_per_round=4),
                                   explore.CorpusStore(str(tmp_path / "w")), 1),
        lambda: explore.regression_gate(explore.CorpusStore(str(tmp_path / "g")), target),
        lambda: explore.device_outcomes(base, explore.DifferentialConfig(seeds=2)),
        lambda: explore.device_outcomes_grid([base], explore.DifferentialConfig(seeds=2)),
        lambda: explore.run_differential([base], explore.DifferentialConfig(seeds=2), host=[
            explore.TierOutcome(*[0] * len(explore.TierOutcome._fields))]),
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


def test_the_native_core_builds_into_the_ignored_build_dir():
    """``native/`` builds its libraries under ``madsim_tpu_torch/_build/``
    (which ``.gitignore`` lists), never beside its sources, so no build
    output shows in ``git status``."""
    from madsim_tpu_torch import native

    assert native.available() and native.simloop() is not None, native.build_error()
    build = os.path.join(PKG, "_build")
    built = [os.path.join(root, f) for root, _, files in os.walk(PKG)
             for f in files if f.endswith(".so")]
    assert built and all(p.startswith(build + os.sep) for p in built), built
    assert native.simloop().__file__.startswith(os.path.join(build, "native") + os.sep)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "madsim_tpu_torch/_build/" in f.read().split()
    proc = subprocess.run(["git", "status", "--porcelain", "--untracked-files=all", "--",
                           "madsim_tpu_torch"], cwd=REPO, capture_output=True, text=True)
    if proc.returncode == 0:  # a checkout without git has no status to read
        assert not [line for line in proc.stdout.splitlines() if ".so" in line], proc.stdout
