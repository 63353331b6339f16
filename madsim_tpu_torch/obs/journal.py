"""The run journal: an append-only JSONL telemetry stream.

One line per event, each carrying a wall-clock timestamp and the run ID
— the ONLY place in the repo where wall-clock time is written to disk
next to sweep results. The journal is explicitly excluded from the
deterministic report bytes: reports (chunk summaries, campaign JSONL,
checked-sweep totals) are pure functions of the work and never read or
embed journal content; the parity tests byte-diff the reports with the
journal enabled vs disabled to pin that invariant.

Line shape (sorted keys)::

    {"kind": "stream_flush", "lo": 0, "k": 32, "run": "9f2c...", "ts": 1722950400.123456}

``kind`` names the event, ``run`` the run ID (one per Telemetry handle),
``ts`` seconds since the epoch. Everything else is the event's own
payload — JSON-able scalars only; the writer rejects nothing and repairs
nothing, so emit clean values.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional


def new_run_id() -> str:
    """A fresh 16-hex-char run ID (collision-safe across hosts: random
    bytes, not a timestamp)."""
    return os.urandom(8).hex()


class Journal:
    """Append-only JSONL writer; every ``write`` is one flushed line, so
    an interrupted run keeps every event up to the kill."""

    def __init__(self, path: str, run_id: Optional[str] = None):
        self.path = path
        self.run_id = run_id or new_run_id()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")
        self._lock = threading.Lock()
        self.write("run_start")

    def write(self, kind: str, **fields) -> None:
        rec = dict(fields)
        rec["kind"] = kind
        rec["run"] = self.run_id
        rec["ts"] = round(time.time(), 6)
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            if self._f.closed:
                return  # post-close writes are dropped, not crashes
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.write(
                    json.dumps(
                        {
                            "kind": "run_end",
                            "run": self.run_id,
                            "ts": round(time.time(), 6),
                        },
                        sort_keys=True,
                    )
                    + "\n"
                )
                self._f.close()


class JournalRecords(list):
    """``read_journal``'s return value: a plain list of record dicts,
    plus ``truncated`` — True when the file ended in a torn partial
    line (a writer killed mid-append) whose bytes were dropped. The
    valid prefix is always returned; only the torn tail is lost."""

    truncated: bool = False


def read_journal(path: str) -> JournalRecords:
    """Parse a journal back into a list of dicts (tests, post-mortems).

    Crash-tolerant by design: the journal is an append-only stream whose
    writer may die mid-line (``kill -9`` between ``write`` and
    ``flush`` landing), so a torn/partial FINAL line is normal operating
    data, not corruption — the valid prefix is returned with
    ``.truncated`` set instead of raising ``JSONDecodeError``. A
    malformed line with MORE data after it is genuine corruption (a torn
    line can only be last in an append-only file) and still raises."""
    out = JournalRecords()
    with open(path) as f:
        lines = f.read().split("\n")
    # a well-formed file ends "...}\n" -> a trailing "" entry; anything
    # else in the final slot is a torn partial record
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                out.truncated = True
                return out
            raise
    return out
