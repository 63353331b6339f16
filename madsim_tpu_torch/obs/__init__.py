"""madsim_tpu_torch.obs — the fleet telemetry subsystem.

One handle, four planes, all strictly OUT-OF-BAND (report bytes are
bit-identical with telemetry on or off — the determinism gate pins it):

- **metrics** (obs/metrics.py): counters/gauges/histograms with labels,
  instrumented in every driver — chunk wall time and device/host phase
  overlap (engine/checkpoint.py), per-round occupancy / refill latency /
  queue depth / retirement flux (engine/stream.py), per-device seeds/s
  (parallel/mesh.py), candidates/s and corpus size (explore/campaign.py),
  suspect/dedup rates (oracle/screen.py), connections and per-API latency
  (the wire servers);
- **journal** (obs/journal.py): append-only JSONL with wall timestamps
  and a run ID;
- **exposition** (obs/export.py): Prometheus text format, served by an
  opt-in localhost HTTP endpoint;
- **trace spans** (tracing.SpanTracer): driver phases as one Chrome/
  Perfetto file — device sweep of chunk N over host check of chunk N−1,
  stream round/refill cadence, checker-pool fan-out.

Drivers take ``telemetry=`` (a :class:`Telemetry` or None); None means
ZERO instrumentation work on the hot path. See docs/observability.md.
"""

from __future__ import annotations

import sys
import time
from contextlib import nullcontext
from typing import Optional

from .journal import (  # noqa: F401
    Journal,
    JournalRecords,
    new_run_id,
    read_journal,
)
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
)
from .export import (  # noqa: F401
    bind_runtime_metrics,
    render_prometheus,
    start_http_server,
)


class Telemetry:
    """The handle a driver is given: registry + optional journal, trace
    recorder and exposition endpoint, torn down together by ``close``.

    - ``registry``: an ``obs.metrics.Registry`` (fresh one by default);
    - ``journal``: a path or a ``Journal`` — every ``event()`` appends
      one JSONL line with wall timestamp + run ID;
    - ``trace``: a path — driver phases recorded through a
      ``tracing.SpanTracer`` and saved there on ``close``;
    - ``http_port``: serve ``/metrics`` (Prometheus text) on localhost;
      0 picks a free port (``telemetry.server.url``).

    Convenience recorders (``count``/``gauge``/``observe``/``event``/
    ``span``) are what the drivers call; each is a no-op for the planes
    not enabled, so a metrics-only handle costs dict updates and nothing
    else.
    """

    def __init__(
        self,
        *,
        registry: Optional[Registry] = None,
        journal=None,
        trace: Optional[str] = None,
        http_port: Optional[int] = None,
        run_id: Optional[str] = None,
    ):
        self.registry = registry if registry is not None else Registry()
        self.run_id = run_id or new_run_id()
        if journal is None or isinstance(journal, Journal):
            self.journal = journal
        else:
            self.journal = Journal(str(journal), run_id=self.run_id)
        self._trace_path = trace
        if trace is not None:
            from ..tracing import SpanTracer

            self.tracer = SpanTracer()
        else:
            self.tracer = None
        self.server = (
            start_http_server(self.registry, port=http_port)
            if http_port is not None
            else None
        )

    # -- recorders (driver-facing) -----------------------------------------

    def count(self, name: str, value: float = 1, help: str = "", **labels):
        self.registry.counter(
            name, help, labels=tuple(sorted(labels))
        ).inc(value, **labels)

    def gauge(self, name: str, value: float, help: str = "", **labels):
        self.registry.gauge(
            name, help, labels=tuple(sorted(labels))
        ).set(value, **labels)

    def observe(self, name: str, value: float, help: str = "", **labels):
        self.registry.histogram(
            name, help, labels=tuple(sorted(labels))
        ).observe(value, **labels)

    def event(self, kind: str, **fields) -> None:
        if self.journal is not None:
            self.journal.write(kind, **fields)

    def span(self, name: str, track: str = "host", **args):
        """Context manager: a driver-phase span on the trace (no-op
        without a trace path)."""
        if self.tracer is None:
            return nullcontext()
        return self.tracer.span(name, track=track, args=args or None)

    def sample(self, name: str, **values) -> None:
        """One counter-series sample on the trace timeline (occupancy,
        queue depth) — the refill-cadence view; no-op without a trace."""
        if self.tracer is not None:
            self.tracer.counter(name, **values)

    def event_mix(self, summary: dict, prefix: str = "engine") -> None:
        """Fold a chunk summary's device-side ``event_mix`` histogram
        (engine/core.py opt-in plane) into per-kind counters."""
        mix = summary.get("event_mix")
        if mix:
            c = self.registry.counter(
                f"{prefix}_events_by_kind_total",
                "device-side event-mix plane, per event kind",
                labels=("kind",),
            )
            for i, v in enumerate(mix):
                c.inc(v, kind=str(i))

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        if self.tracer is not None and self._trace_path is not None:
            self.tracer.save(self._trace_path)
        if self.journal is not None:
            self.journal.close()
        if self.server is not None:
            self.server.close()

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _fmt_eta(seconds: float) -> str:
    if seconds < 0 or seconds != seconds or seconds == float("inf"):
        return "?"
    s = int(seconds)
    if s >= 3600:
        return f"{s // 3600}h{(s % 3600) // 60:02d}m"
    if s >= 60:
        return f"{s // 60}m{s % 60:02d}s"
    return f"{s}s"


class Heartbeat:
    """Progress heartbeat driven by the obs registry (seeds done,
    seeds/s, occupancy, ETA) — what a long sweep prints instead of
    ad-hoc ``perf_counter`` lines.

    Reads ``<prefix>_seeds_done_total`` (counter) and, when present,
    ``<prefix>_occupancy`` (gauge) from the registry; call ``tick()``
    after progress lands (a chunk merge, a stream flush). Lines go to
    stderr so stdout stays machine-readable (the scripts' JSON lines).
    """

    def __init__(
        self,
        registry: Registry,
        total_seeds: int,
        *,
        prefix: str = "sweep",
        out=None,
        min_interval_s: float = 0.0,
    ):
        self.registry = registry
        self.total = int(total_seeds)
        self.prefix = prefix
        self.out = out if out is not None else sys.stderr
        self.min_interval_s = min_interval_s
        self._t0 = time.perf_counter()
        self._last = 0.0

    def tick(self, force: bool = False) -> Optional[str]:
        now = time.perf_counter()
        if not force and (now - self._last) < self.min_interval_s:
            return None
        self._last = now
        done = self.registry.get(f"{self.prefix}_seeds_done_total") or 0
        rate = done / max(now - self._t0, 1e-9)
        eta = (self.total - done) / rate if rate > 0 else float("inf")
        occ = self.registry.get(f"{self.prefix}_occupancy")
        line = (
            f"[hb] {int(done)}/{self.total} seeds  {rate:,.0f} seeds/s"
            + (f"  occ {occ:.3f}" if occ is not None else "")
            + f"  ETA {_fmt_eta(eta)}"
        )
        print(line, file=self.out, flush=True)
        return line
