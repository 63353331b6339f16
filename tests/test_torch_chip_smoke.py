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
