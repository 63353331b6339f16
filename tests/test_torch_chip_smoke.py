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


def test_checked_sweep_phase_on_the_plain_path():
    """Phase 9 on the CPU at the rehearsal sizes of the golden files: the
    clean checked sweep (two chunks) and the stale-read sweeps through
    both decode routes equal the JAX-made goldens, the parity, screen and
    canonical-decode checks and the snapshot resume pass, and no kernel
    launches on the CPU."""
    out = chip_smoke.phase_checked_sweep(
        torch.device("cpu"), clean=chip_smoke.CLEAN_RUNS[1], stale=chip_smoke.STALE_RUNS[1],
        workers=2, parity_seeds=8, ckpt=(16, 20),
    )
    assert out["launches"] == 0 and out["steps"] > 0
    assert out["report"]["seeds"] == chip_smoke.CLEAN_RUNS[1][0]
    assert out["phases_s"]["sweep_seconds"] > 0 and "oracle_check_seconds" in out["phases_s"]
    assert out["stale"]["hist_violations"] > 0


def test_pop_min_bound_at_the_etcd_queue_width():
    """Phase 9's queue is 48 slots: 16,384 x 48 int64 deadlines read, the
    tie words read and slot and found written, over HBM bandwidth."""
    ms, by = chip_smoke.bound_ms(16_384, 48)
    assert by == "bytes"
    assert ms == pytest.approx((16_384 * 48 * 8 + 16_384 * 9) / 3.35e12 * 1e3)
    wl, ecfg = chip_smoke.etcd_path()
    assert ecfg.queue_capacity == 48 and wl.hist_slots == chip_smoke.ETCD_HIST_SLOTS


def test_new_phases_configs_agree_with_their_goldens():
    """Phases 10-13 run the configs their golden files were made from:
    each path's model config has the golden's fields (the rest at their
    defaults) and its engine config the golden's overrides; the widths
    are the published ones (queue 48 for kafka and S3)."""
    from madsim_tpu_torch.engine import faults
    from madsim_tpu_torch.models import etcd, kafka, s3

    def fields(cfg, cls):
        d = {k: v for k, v in cfg._asdict().items() if v != getattr(cls(), k)}
        if d.get("faults") is not None:
            d["faults"] = {k: v for k, v in d["faults"]._asdict().items()
                           if v != getattr(faults.FaultSpec(), k)}
        return d

    cases = {
        "kafka_summary.json": (chip_smoke.kafka_path(), kafka, "kafka"),
        "s3_summary.json": (chip_smoke.s3_path(), s3, "s3"),
        "s3_bug_summary.json": (chip_smoke.s3_path(bug=True), s3, "s3"),
        "kafka_checked_clean.json": (chip_smoke.kafka_checked_path(), kafka, "kafka"),
        "kafka_checked_bug.json": (chip_smoke.kafka_checked_path(bug=True), kafka, "kafka"),
        "etcd_stream.json": (chip_smoke.stream_path(), etcd, "etcd"),
    }
    assert sorted(cases) == sorted(chip_smoke.GOLDEN_CONFIGS)
    for name, ((wl, ecfg), mod, key) in cases.items():
        golden = chip_smoke.load_golden(name)
        assert golden["config"] == chip_smoke.GOLDEN_CONFIGS[name]
        cfg = wl.init.args[0]
        cls = type(cfg)
        got = fields(cfg, cls)
        want = dict(golden["config"][key])
        if "faults" in golden["config"]:
            want["faults"] = golden["config"]["faults"]
        assert got == want, name
        assert ecfg == mod.engine_config(cfg, **golden["config"]["engine"]), name
    kafka_ecfg = chip_smoke.kafka_path()[1]
    s3_ecfg = chip_smoke.s3_path()[1]
    assert (kafka_ecfg.queue_capacity, kafka_ecfg.time_limit_ns) == (48, 3_000_000_000)
    assert (s3_ecfg.queue_capacity, s3_ecfg.time_limit_ns) == (48, 5_000_000_000)
    # the golden sizes are the ones the phases run, card and rehearsal
    assert sorted(chip_smoke.load_golden("kafka_summary.json")["summaries"]) == sorted(
        f"seeds={n}" for n in chip_smoke.KAFKA_RUNS)
    assert sorted(chip_smoke.load_golden("etcd_stream.json")["totals"]) == sorted(
        chip_smoke.run_key(n, c) for n, c in chip_smoke.STREAM_RUNS)
    assert chip_smoke.STREAM_RUNS[0] == (16_384, 8_192) and chip_smoke.STREAM_POOL[0] == 8_192


def test_kafka_and_s3_replay_seeds_violate():
    """The replayed seeds are violating ones on the CPU port."""
    from madsim_tpu_torch.engine import core

    for path, seed in ((chip_smoke.kafka_path(bug=True), chip_smoke.KAFKA_REPLAY_SEED),
                       (chip_smoke.s3_path(bug=True), chip_smoke.S3_REPLAY_SEED)):
        wl, ecfg = path
        final = core.run_sweep(wl, ecfg, [seed], device="cpu")
        assert bool(final.wstate.violation[0])
