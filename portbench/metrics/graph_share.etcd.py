"""Reader of the per-layer metric ``graph_share.etcd``: the share of the
window's engine steps that ``core.drive`` served by replaying its step
graph (the program's ``sweep_chunk_graph_steps`` over
``sweep_chunk_steps``, summed over the window's chunks), %. None where
the program observes no graph steps (a program without the graph)."""

from __future__ import annotations

from typing import Optional


def read(records: dict) -> Optional[float]:
    tel = records.get("telemetry") or {}
    graphed, steps = tel.get("sweep_chunk_graph_steps"), tel.get("sweep_chunk_steps")
    if not graphed or not steps or not sum(steps):
        return None
    return 100.0 * sum(graphed) / sum(steps)
