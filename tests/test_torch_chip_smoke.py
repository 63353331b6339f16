"""``chip_smoke.py`` rehearsed on the CPU: what it computes without a card
(the bound, the main-path and parity phases on the plain path) and that
it refuses to run — printing no result — without CUDA or outside a
checkout."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bound_is_the_bytes_of_one_decision():
    ms, by = chip_smoke.bound_ms(16_384, 64)
    assert by == "bytes"
    bytes_moved = 16_384 * 64 * 8 + 16_384 * (4 + 4 + 1)
    assert ms == pytest.approx(bytes_moved / 3.35e12 * 1e3)


def test_main_path_and_parity_phases_on_the_plain_path():
    """Phases 3 and 4 on the CPU at 64 seeds: the sweep finishes, no
    kernel launches on the CPU, and the lanes equal the CPU port and the
    golden summary made by the JAX reference."""
    final, launches = chip_smoke.phase_main_path(torch.device("cpu"), num_seeds=64)
    assert launches == 0
    chip_smoke.phase_parity(
        final, os.path.join(REPO, "madsim_tpu_torch", "data", "flagship_summary.json")
    )


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_refuses_without_cuda_or_outside_a_checkout(alone, tmp_path):
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA card is present: the script legitimately runs")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_megasweep_bound_is_int32_operations():
    """The megasweep call is bound by its integer work, not its bytes:
    16,384 seeds x 512 events of 1,530 32-bit integer instructions (fold_in
    and the 8 threefry blocks whose words the event reads, 58 slots) at the
    issue ceiling (132 SMs x 128 lanes x 1.98 GHz), against ~106 MB moved."""
    per_seed = 3_230
    events = 16_384 * 512
    ms, by = chip_smoke.megasweep_bound_ms(per_seed * 16_384, (per_seed - 8) * 16_384,
                                           events, 58)
    assert by == "operations"
    ops = events * (9 * 68 + 8 + 58 * 15 + 40)
    assert ms == pytest.approx(ops / (132 * 128 * 1.98e9) * 1e3)
    assert 0.35 < ms < 0.42
    assert chip_smoke.megasweep_ops_per_event(58) == 1_530


def test_megasweep_phase_on_the_plain_path():
    """Phase 6 on the CPU at a small size: the path's entry point equals
    the plain version on every leaf, no kernel launches, and the shapes
    of the reference's tests (the time-limit case included) agree."""
    out = chip_smoke.phase_megasweep(torch.device("cpu"), num_seeds=16, steps=8)
    assert out["launches"] == 0 and out["equal"] and out["max_abs_err"] == 0
    assert out["events"] == 16 * 8
    assert out["bound_by"] in ("bytes", "operations") and out["bound_ms"] > 0


def test_ab_phase_refuses_the_cpu():
    """Phase 7 measures the card: without one it refuses, never times
    the CPU under a device name."""
    from madsim_tpu_torch import bench_megakernel

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the A/B legitimately runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_megakernel.bench_batch(1024)


def test_spec_as_data_phase_on_the_plain_path():
    """Phase 8 on the CPU at a small size: both candidates fire fault
    events and their first lanes equal a separate CPU run."""
    out = chip_smoke.phase_spec_as_data(torch.device("cpu"), lanes=12, parity_lanes=4)
    assert out["launches"] == 0 and out["steps"] > 0
    assert min(out["fired"]) > 0
