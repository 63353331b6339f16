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
    """The megasweep call is bound by the integer work its events need,
    not by its bytes, counted on a plain-path run: on the probe every
    event is taken with 5 live slots at its pop and no tied minimum, so
    it needs 611 32-bit instructions (fold_in 68, w0 69, 40 fixed, 5 x 4
    at the pop, w2..w7 6 x 69); 16,384 seeds x 512 such events are about
    0.153 ms at the issue ceiling (132 SMs x 128 lanes x 1.98 GHz),
    against ~106 MB moved (0.032 ms). A tied minimum adds w1 (69) and 13
    per slot at it."""
    from madsim_tpu_torch.engine import megakernel

    cpu = torch.device("cpu")
    _, counts = megakernel.run_megasweep_counted(chip_smoke.probe_state(cpu, 32, 16), 16)
    events = 32 * 16
    assert counts == (events, events, 0, 0, 5 * events)
    assert chip_smoke.megasweep_ops(counts) == 611 * events
    scale = 16_384 * 512 // events  # the same events at the chip run's size
    full = megakernel.MegasweepCounts(*(n * scale for n in counts))
    per_seed = 3_230
    ms, by = chip_smoke.megasweep_bound_ms(per_seed * 16_384, (per_seed - 8) * 16_384, full)
    assert by == "operations"
    assert ms == pytest.approx(16_384 * 512 * 611 / (132 * 128 * 1.98e9) * 1e3)
    assert 0.15 < ms < 0.16

    steps, seeds = chip_smoke.PROBE_STATE_SHAPE
    tied_state = chip_smoke.probe_state(cpu, seeds, steps, edit=chip_smoke.tied_deadlines)
    _, tied = megakernel.run_megasweep_counted(tied_state, steps)
    assert (tied.tied, tied.tied_slots) == (3 * seeds, 7 * seeds)  # 3-, 2- and 2-way
    untied = tied._replace(tied=0, tied_slots=0)
    assert (chip_smoke.megasweep_ops(tied) - chip_smoke.megasweep_ops(untied)
            == 3 * seeds * 69 + 7 * seeds * 13)
    empty = chip_smoke.probe_state(cpu, seeds, steps, edit=chip_smoke.empty_queue)
    _, none_found = megakernel.run_megasweep_counted(empty, steps)
    # an empty seed's one event finds nothing and takes nothing
    assert none_found.events - none_found.taken == seeds // 2


def test_megasweep_phase_on_the_plain_path():
    """Phase 6 on the CPU at a small size: the path's entry point equals
    the plain version on every leaf, no kernel launches, and the shapes
    of the reference's tests (the time-limit case included) and the
    edited probe states agree."""
    out = chip_smoke.phase_megasweep(torch.device("cpu"), num_seeds=16, steps=8)
    assert out["launches"] == 0 and out["equal"] and out["max_abs_err"] == 0
    assert out["counts"].events == out["counts"].taken == 16 * 8
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
