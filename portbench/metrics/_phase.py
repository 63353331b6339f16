"""What the metric files of the program's own spans and counters read:
the idle device time under each phase range of the step (``step.*``,
``engine/core._span``), and the pipelined driver's per-chunk
observations (``sweep_screen_seconds``, ``sweep_chunk_steps``,
``sweep_chunk_events``)."""

from __future__ import annotations

from typing import Optional

PHASE = "step."


def idle_ms(records: dict, label: str) -> Optional[float]:
    """Idle device ms per profiled step whose gap fell under the range
    ``label`` (the profile's ``idle_gaps_s``, summed over the sub-window's
    steps). 0.0 where the profile names other phases but not this one (no
    gap fell there); None with no device profile, or where its gaps name
    no phase at all (a program without the ranges)."""
    p = records.get("profile")
    if not p or not p.get("device_ops"):
        return None
    gaps = {name: s for name, s in p["idle_gaps_s"]}
    if not any(name.startswith(PHASE) for name in gaps):
        return None
    return gaps.get(label, 0.0) / p["steps"] * 1e3


def screen_s(records: dict) -> Optional[float]:
    """The program's ``sweep_screen_seconds``, mean over the window's
    chunks."""
    vals = (records.get("telemetry") or {}).get("sweep_screen_seconds")
    return sum(vals) / len(vals) if vals else None


def chunk_occupancy(records: dict) -> Optional[float]:
    """Events the window's chunks committed over their engine steps times
    the lanes of a chunk (the program's ``sweep_chunk_events`` and
    ``sweep_chunk_steps``), %."""
    tel = records.get("telemetry") or {}
    events, steps = tel.get("sweep_chunk_events"), tel.get("sweep_chunk_steps")
    w = records.get("window") or {}
    if not events or not steps or not w.get("chunks") or not sum(steps):
        return None
    lanes = w["seeds"] / w["chunks"]
    return 100.0 * sum(events) / (sum(steps) * lanes)
