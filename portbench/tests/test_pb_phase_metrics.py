"""The readers of the program's phase ranges and per-chunk counters, on
synthetic records: an idle label absent from a profile that names other
phases reads 0.0; no profile, a profile with no device operations, or
one whose gaps name no phase (a program without the ranges) reads None;
the screen's mean and the chunk occupancy's arithmetic."""

import pytest

from portbench import harness

STEPS = 16


def _profile(gaps, device_ops=2179 * STEPS):
    return {"steps": STEPS, "device_ops": device_ops, "idle_gaps_s": gaps}


def _read(name, records):
    return harness.load_module("metrics", name).read(records)


IDLE = [(f"{ph}_idle_ms.{cell}", f"step.{ph}")
        for cell in ("raft", "etcd") for ph in ("handler", "push", "select")]


@pytest.mark.parametrize("name,label", IDLE)
def test_idle_reads_its_phase_per_step(name, label):
    gaps = [[label, 0.032], ["python between ops", 0.5], ["step.draws", 0.004]]
    assert _read(name, {"profile": _profile(gaps)}) == pytest.approx(0.032 / STEPS * 1e3)


@pytest.mark.parametrize("name,label", IDLE)
def test_idle_absent_label_reads_zero(name, label):
    gaps = [["step.pop", 0.01], ["python between ops", 0.2]]
    assert _read(name, {"profile": _profile(gaps)}) == 0.0


@pytest.mark.parametrize("name", [n for n, _ in IDLE])
def test_idle_without_profile_or_phases_reads_none(name):
    assert _read(name, {}) is None
    assert _read(name, {"profile": None}) is None
    assert _read(name, {"profile": _profile([["step.handler", 0.1]], device_ops=0)}) is None
    # the parent's gaps are labelled by torch ops: no phase range exists
    assert _read(name, {"profile": _profile([["aten::where", 0.1],
                                             ["python between ops", 0.1]])}) is None


def test_screen_mean_and_missing():
    assert _read("screen_s.etcd", {"telemetry": {"sweep_screen_seconds": [0.5, 0.25, 0.75]}}) \
        == pytest.approx(0.5)
    assert _read("screen_s.etcd", {"telemetry": {"sweep_chunk_seconds": [1.0]}}) is None
    assert _read("screen_s.etcd", {}) is None


def test_occupancy_arithmetic():
    lanes, chunks = 1024, 3
    tel = {"sweep_chunk_steps": [192, 256, 192],
           "sweep_chunk_events": [150_000, 180_000, 160_000]}
    records = {"telemetry": tel, "window": {"seeds": lanes * chunks, "chunks": chunks}}
    want = 100.0 * 490_000 / (640 * lanes)
    assert _read("occupancy.etcd", records) == pytest.approx(want)
    assert 0.0 < want <= 100.0


def test_occupancy_missing_reads_none():
    window = {"seeds": 64, "chunks": 2}
    assert _read("occupancy.etcd", {"window": window}) is None
    assert _read("occupancy.etcd", {"window": window,
                                    "telemetry": {"sweep_chunk_seconds": [1.0]}}) is None
    assert _read("occupancy.etcd", {"telemetry": {"sweep_chunk_steps": [1],
                                                  "sweep_chunk_events": [1]}}) is None
