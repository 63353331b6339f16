"""Tracing: node/task-scoped logging + a chrome-trace exporter.

The reference enters a tracing span per node and per task on every poll so
log lines carry simulation identity (madsim/src/sim/task/mod.rs:121,193;
runtime/context.rs:58-64). Python's analogue: a logging.Filter that stamps
records with ``sim_time`` / ``node`` / ``task`` from the ambient context —
installed by ``runtime.init_logger`` — plus helpers to log through.

Beyond the reference (which has no trace exporter), ``Tracer`` records
per-task poll spans and emits the Chrome trace-event JSON format
(chrome://tracing / Perfetto), with virtual time as the timeline — a
practical way to *see* a schedule when debugging a failing seed.

``SpanTracer`` scales the same exporter from one seed's polls to the
FLEET drivers (the reference's madsim_tpu/obs): wall-clock phase spans on named tracks
("device", "host", "stream", "checkers"), so one trace file shows the
device sweep of chunk N overlapping the host decode/check of chunk N−1,
the stream pool's round/refill cadence, and the checker-pool fan-out.
Same JSON shape, same viewers; only the clock differs (virtual ns for
``Tracer``, wall µs since construction for ``SpanTracer``).
"""

from __future__ import annotations

import json
import logging
import threading
import time as _walltime
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from . import context


class SimContextFilter(logging.Filter):
    """Stamps every record with the ambient sim identity."""

    def filter(self, record: logging.LogRecord) -> bool:
        task = context.try_current_task()
        handle = context.try_current_handle()
        record.sim_time = (
            f"{handle.time.elapsed():.6f}" if handle is not None else "-"
        )
        record.node = task.node.name if task is not None else "-"
        record.task = (task.name or str(task.id)) if task is not None else "-"
        return True


LOG_FORMAT = "%(levelname)s [%(sim_time)ss %(node)s/%(task)s] %(name)s: %(message)s"


class Tracer:
    """Chrome-trace recorder for one simulation run.

    Register with ``tracer.install(runtime)`` before ``block_on``; every
    task poll becomes a complete event ("X") on the node's row, with
    virtual microseconds as the timeline. ``save(path)`` writes JSON
    loadable in chrome://tracing or Perfetto.
    """

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []
        self._runtime: Optional[Any] = None

    def install(self, runtime: Any) -> "Tracer":
        executor = runtime.executor
        tracer = self
        # tracing instruments every poll, so the run must take the Python
        # loop — the compiled core (native/simloop.c) steps coroutines in
        # C and would bypass the _poll wrapper below. Schedules are
        # byte-identical either way; only wall-clock differs.
        executor._cloop = None
        original_poll = executor._poll

        def traced_poll(task: Any) -> None:
            time = executor.time
            start_ns = time.now_ns
            original_poll(task)
            tracer.events.append(
                {
                    "name": task.name or f"task-{task.id}",
                    "cat": "poll",
                    "ph": "X",
                    "pid": int(task.node.id),
                    "tid": int(task.id),
                    "ts": start_ns / 1000.0,  # chrome uses microseconds
                    "dur": max((time.now_ns - start_ns) / 1000.0, 0.001),
                }
            )

        executor._poll = traced_poll
        self._runtime = runtime
        for node in executor.nodes.values():
            self._name_node(node)
        return self

    def _name_node(self, node: Any) -> None:
        self.events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": int(node.id),
                "args": {"name": node.name},
            }
        )

    def to_json(self) -> str:
        # name any nodes created after install
        if self._runtime is not None:
            named = {e["pid"] for e in self.events if e.get("ph") == "M"}
            for node in self._runtime.executor.nodes.values():
                if int(node.id) not in named:
                    self._name_node(node)
        return json.dumps({"traceEvents": self.events})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


class SpanTracer:
    """Chrome-trace recorder for DRIVER phases: wall-clock complete
    events ("X") on named tracks, plus counter events ("C") for series
    like pool occupancy — the fleet-scale sibling of :class:`Tracer`.

    Tracks are lazily numbered in first-use order and named through "M"
    ``thread_name`` metadata, so Perfetto shows "device" / "host" /
    "stream" rows instead of bare thread ids. Timestamps are wall
    microseconds since construction (Chrome's unit). Thread-safe: the
    checker pool and the HTTP exporter may emit concurrently.
    """

    PID = 0  # one logical process: the driver

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": self.PID,
                "args": {"name": "madsim_tpu driver"},
            }
        ]
        self._t0 = _walltime.perf_counter_ns()
        self._tracks: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _now_us(self) -> float:
        return (_walltime.perf_counter_ns() - self._t0) / 1000.0

    def _tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            tid = self._tracks[track] = len(self._tracks)
            self.events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": self.PID,
                    "tid": tid,
                    "args": {"name": track},
                }
            )
        return tid

    def complete(
        self,
        name: str,
        start_us: float,
        dur_us: float,
        track: str = "host",
        cat: str = "phase",
        args: Optional[dict] = None,
    ) -> None:
        """One finished span from precomputed times (µs since t0)."""
        with self._lock:
            ev = {
                "name": name,
                "cat": cat,
                "ph": "X",
                "pid": self.PID,
                "tid": self._tid(track),
                "ts": start_us,
                "dur": max(dur_us, 0.001),
            }
            if args:
                ev["args"] = args
            self.events.append(ev)

    @contextmanager
    def span(
        self,
        name: str,
        track: str = "host",
        cat: str = "phase",
        args: Optional[dict] = None,
    ):
        """Record the wrapped block as one complete event on ``track``."""
        start = self._now_us()
        try:
            yield self
        finally:
            self.complete(
                name, start, self._now_us() - start, track, cat, args
            )

    def instant(self, name: str, track: str = "host", args=None) -> None:
        with self._lock:
            ev = {
                "name": name,
                "ph": "i",
                "s": "t",  # thread-scoped instant
                "pid": self.PID,
                "tid": self._tid(track),
                "ts": self._now_us(),
            }
            if args:
                ev["args"] = args
            self.events.append(ev)

    def counter(self, name: str, **values: float) -> None:
        """One sample of a counter series (occupancy, queue depth) —
        Perfetto renders these as a step chart over the trace."""
        with self._lock:
            self.events.append(
                {
                    "name": name,
                    "ph": "C",
                    "pid": self.PID,
                    "ts": self._now_us(),
                    "args": {k: float(v) for k, v in values.items()},
                }
            )

    def to_json(self) -> str:
        with self._lock:
            return json.dumps({"traceEvents": list(self.events)})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


def instrument(logger: Optional[logging.Logger] = None):
    """Decorator: log entry/exit of an async op with sim identity (the
    ``#[instrument]`` analogue on net/fs ops)."""
    log = logger or logging.getLogger("madsim")

    def deco(fn):
        import functools

        @functools.wraps(fn)
        async def wrapper(*args: Any, **kwargs: Any):
            log.debug("enter %s", fn.__qualname__)
            try:
                return await fn(*args, **kwargs)
            finally:
                log.debug("exit %s", fn.__qualname__)

        return wrapper

    return deco
