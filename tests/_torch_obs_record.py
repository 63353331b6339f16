"""The record of a telemetry handle, as the port's telemetry parity tests
and ``chip_smoke.py`` phase 19's rehearsal compare it: every counter and
gauge that is not a wall time, the observation count of each histogram
series, and the journal's events without their wall fields; and a saved
trace's spans. Imports neither package (the mesh jobs' ranks use it)."""

from __future__ import annotations

import json
import re

RUN_ID = "00000000cafef00d"
WALL_METRIC = re.compile(r"(_seconds|_per_s|_per_s_per_device|_utilization)$")

# the port's own histograms, which the reference's drivers do not record:
# the pipelined driver's per-chunk screen time, engine steps (and those
# of them its step graphs replayed) and events
PORT_ONLY_METRICS = ("sweep_screen_seconds", "sweep_chunk_steps", "sweep_chunk_graph_steps",
                     "sweep_chunk_events")


def record(obs, tel, journal_path) -> dict:
    metrics = []
    for name, kind, help, labelnames, series in tel.registry.collect():
        if kind == "histogram":
            rows = [(key, int(sum(row[:-1]))) for key, row in series]
        elif WALL_METRIC.search(name):
            rows = [key for key, _ in series]
        else:
            rows = series
        metrics.append((name, kind, help, tuple(labelnames), rows))
    journal = [{k: v for k, v in r.items() if k != "ts" and not k.endswith("_s")}
               for r in obs.read_journal(str(journal_path))]
    return {"metrics": metrics, "journal": journal}


def without(rec: dict, drop=()) -> dict:
    """``rec`` with the metrics named in ``drop`` (whole names) left out."""
    return {**rec, "metrics": [m for m in rec["metrics"] if m[0] not in drop]}


def spans(trace_path, drop=()) -> list:
    """The trace's complete spans and counter samples by (phase, name,
    track name), sorted; ``drop`` names span prefixes left out."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    tracks = {e["tid"]: e["args"]["name"] for e in events
              if e["ph"] == "M" and e["name"] == "thread_name"}
    return sorted((e["ph"], e["name"], tracks.get(e.get("tid"), "")) for e in events
                  if e["ph"] in ("X", "C") and not e["name"].startswith(tuple(drop)))
