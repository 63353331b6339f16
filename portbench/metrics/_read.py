"""What the metric files read, by quantity; each ``<name>.py`` binds one."""

from __future__ import annotations

from typing import Optional

from portbench.harness import pop_min_bound_s

GIB = float(1 << 30)


def _profile(records: dict) -> Optional[dict]:
    p = records.get("profile")
    return p if p and p.get("device_ops") else None


def step_ms(records: dict) -> Optional[float]:
    """Window wall time over the ``step_batch`` calls in the window, ms."""
    w = records.get("window") or {}
    return w["wall_s"] / w["steps"] * 1e3 if w.get("steps") else None


def occupancy(records: dict) -> Optional[float]:
    """Events committed over (steps x lanes) in the window, %."""
    w = records.get("window") or {}
    return 100.0 * w["events"] / (w["steps"] * w["lanes"]) if w.get("steps") else None


def _mean(records: dict, name: str) -> Optional[float]:
    vals = (records.get("telemetry") or {}).get(name)
    return sum(vals) / len(vals) if vals else None


def chunk_sweep_s(records: dict) -> Optional[float]:
    """The program's ``sweep_chunk_seconds``, mean over the window's chunks."""
    return _mean(records, "sweep_chunk_seconds")


def host_phase_s(records: dict) -> Optional[float]:
    """The program's ``sweep_host_phase_seconds``, mean over the window's
    chunks."""
    return _mean(records, "sweep_host_phase_seconds")


def kernels_per_step(records: dict) -> Optional[float]:
    """Device operations per ``step_batch`` in the profiled sub-window."""
    p = _profile(records)
    return p["device_ops"] / p["steps"] if p else None


def handler_ms(records: dict) -> Optional[float]:
    """Device ms per call of the model's handler on a mid-window state."""
    p = _profile(records)
    return p["handler_s"] * 1e3 if p and p.get("handler_s") else None


def pop_min_roofline(records: dict) -> Optional[float]:
    """The pop-min decision's bytes bound over its mean kernel time in the
    profiled sub-window, %."""
    p = _profile(records)
    if not p or not p.get("pop_min_mean_s"):
        return None
    return 100.0 * pop_min_bound_s(p["lanes"], p["queue"]) / p["pop_min_mean_s"]


def device_idle(records: dict) -> Optional[float]:
    """1 minus the device's busy time (the union of its operations in the
    profiled sub-window) over the wall time of as many steps unprofiled, %."""
    p = _profile(records)
    return 100.0 * (1.0 - p["busy_s"] / p["wall_plain_s"]) if p else None


def peak_mem_gib(records: dict) -> Optional[float]:
    """``torch.cuda.max_memory_allocated()`` over the window, GiB."""
    peak = (records.get("memory") or {}).get("window_peak_bytes")
    return peak / GIB if peak else None


def suspect_share(records: dict) -> Optional[float]:
    """Suspect lanes over screened lanes in the window's reports, %."""
    r = records.get("report") or {}
    return 100.0 * r["hist_suspects"] / r["hist_screened"] if r.get("hist_screened") else None
