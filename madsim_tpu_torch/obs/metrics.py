"""Fleet metrics registry: counters / gauges / histograms with labels.

The device tier ran as a black box — the streaming service, pipelined
driver, mesh shards, campaign loop and checker pool emitted nothing
until a chunk summary landed. This registry is the substrate every
driver instruments against (``Telemetry`` in ``obs/__init__.py`` wires
it to the run journal, the Prometheus exposition endpoint and the trace
recorder).

Out-of-band BY CONSTRUCTION: nothing here ever feeds ``summarize`` /
``merge_summaries`` / report writing — metric values are wall-clock-side
observations, and the determinism gate byte-diffs reports with telemetry
on vs off. Keep it that way: a metric
read must never influence a report byte.

Stdlib only (threading), no deps — the registry must import on every
tier, including the forked checker-pool children.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# Prometheus-compatible default latency buckets (seconds) — wide enough
# for both a 2 ms stream round and a 60 s pod chunk
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_KINDS = ("counter", "gauge", "histogram")


def _label_key(labelnames: Tuple[str, ...], labels: dict) -> Tuple[str, ...]:
    """The child key of one label assignment — declared names only, in
    declaration order, values coerced to str (Prometheus semantics)."""
    extra = set(labels) - set(labelnames)
    if extra:
        raise ValueError(
            f"undeclared label(s) {sorted(extra)}; declared: {labelnames}"
        )
    return tuple(str(labels.get(name, "")) for name in labelnames)


class Counter:
    """Monotonic counter; ``inc`` only (a decrement is a bug upstream)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labels: Tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labels)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def inc(self, value: float = 1, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({value})")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + value

    def get(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._values.get(key, 0)

    def series(self) -> List[Tuple[Tuple[str, ...], float]]:
        with self._lock:
            return sorted(self._values.items())


class Gauge:
    """Point-in-time value (pool occupancy, queue depth, corpus size)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels: Tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labels)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = value

    def inc(self, value: float = 1, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + value

    def get(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._values.get(key, 0)

    def series(self) -> List[Tuple[Tuple[str, ...], float]]:
        with self._lock:
            return sorted(self._values.items())


class Histogram:
    """Cumulative-bucket histogram (per-API latency, round occupancy).

    Each child keeps per-bucket counts plus sum/count, rendered in the
    Prometheus ``_bucket``/``_sum``/``_count`` shape by obs/export.py."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        labels: Tuple[str, ...] = (),
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
    ):
        if tuple(buckets) != tuple(sorted(buckets)):
            raise ValueError(f"buckets must be sorted: {buckets}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labels)
        self.buckets = tuple(float(b) for b in buckets)
        # child key -> [bucket counts..., +Inf count, sum]
        self._values: Dict[Tuple[str, ...], List[float]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            row = self._values.get(key)
            if row is None:
                row = self._values[key] = [0.0] * (len(self.buckets) + 2)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    row[i] += 1
                    break
            else:
                row[len(self.buckets)] += 1  # +Inf bucket
            row[-1] += value

    def get(self, **labels) -> Tuple[int, float]:
        """(count, sum) of one child."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            row = self._values.get(key)
            if row is None:
                return 0, 0.0
            return int(sum(row[:-1])), row[-1]

    def series(self) -> List[Tuple[Tuple[str, ...], List[float]]]:
        with self._lock:
            return sorted((k, list(v)) for k, v in self._values.items())


class Registry:
    """Named metric families; creation is idempotent per (name, kind).

    ``callback_gauge`` registers a pull-time gauge: the callable runs at
    collect/render time and returns either a scalar or a ``{label value:
    number}`` dict — how the host-tier ``RuntimeMetrics`` shim
    (``num_tasks_by_node``/``by_spawn_site``) joins the exposition path
    without a push loop (obs/export.py ``bind_runtime_metrics``)."""

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._callbacks: Dict[str, Tuple[str, Tuple[str, ...], Callable]] = {}
        self._lock = threading.Lock()

    def _get_or_make(self, cls, name: str, help: str, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"requested {cls.kind}"
                    )
                return m
            if name in self._callbacks:
                raise ValueError(f"metric {name!r} is a callback gauge")
            m = cls(name, help, tuple(labels), **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "", labels=()) -> Counter:
        return self._get_or_make(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labels)

    def histogram(
        self, name: str, help: str = "", labels=(),
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_make(
            Histogram, name, help, labels, buckets=tuple(buckets)
        )

    def callback_gauge(
        self, name: str, fn: Callable, help: str = "", label: str = ""
    ) -> None:
        """A gauge whose value(s) are pulled from ``fn()`` at collect
        time. ``fn`` returns a number, or (with ``label`` set) a dict of
        ``{label value: number}``."""
        with self._lock:
            if name in self._metrics:
                raise ValueError(f"metric {name!r} already registered")
            self._callbacks[name] = (help, (label,) if label else (), fn)

    def get(self, name: str, **labels):
        """Convenience read for heartbeats/tests: the child value, or
        None when the family does not exist yet."""
        with self._lock:
            m = self._metrics.get(name)
        if m is None:
            return None
        return m.get(**labels)

    def metric(self, name: str):
        """The metric family object itself (or None) — for callers that
        need ``series()``/``buckets`` rather than one child value."""
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> Iterable[Tuple[str, str, str, Tuple[str, ...], list]]:
        """Snapshot every family: ``(name, kind, help, labelnames,
        series)`` tuples, name-sorted — the renderer's input."""
        with self._lock:
            metrics = sorted(self._metrics.items())
            callbacks = sorted(self._callbacks.items())
        out = []
        for name, m in metrics:
            out.append((name, m.kind, m.help, m.labelnames, m.series()))
        for name, (help, labelnames, fn) in callbacks:
            try:
                val = fn()
            except Exception:  # noqa: BLE001 — exposition must not crash
                continue
            if isinstance(val, dict):
                series = sorted(
                    ((str(k),), float(v)) for k, v in val.items()
                )
            else:
                series = [((), float(val))]
            out.append((name, "gauge", help, labelnames, series))
        return sorted(out)

    def snapshot(self) -> dict:
        """Plain-dict view (journal dumps, heartbeats): ``{name: value}``
        for unlabeled scalars, ``{name: {"label=value,...": v}}`` for
        labeled families, ``{name: {"count": c, "sum": s}}``-style rows
        for histograms."""
        out: dict = {}
        for name, kind, _help, labelnames, series in self.collect():
            fam: dict = {}
            for key, val in series:
                lk = ",".join(f"{n}={v}" for n, v in zip(labelnames, key))
                if kind == "histogram":
                    fam[lk] = {"count": int(sum(val[:-1])), "sum": val[-1]}
                else:
                    fam[lk] = val
            out[name] = fam.get("", fam) if list(fam) == [""] else fam
        return out


# the default registry: scripts and drivers that are not handed an
# explicit Telemetry may still share one process-wide registry
_DEFAULT = Registry()


def default_registry() -> Registry:
    return _DEFAULT
