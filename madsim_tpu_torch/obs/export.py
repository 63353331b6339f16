"""Prometheus text exposition + the opt-in local HTTP endpoint.

``render_prometheus(registry)`` produces the text format (v0.0.4) from
an ``obs.metrics.Registry`` snapshot; ``start_http_server`` serves it at
``/metrics`` from a daemon thread for long-running sweeps — opt-in only
(``Telemetry(http_port=...)``), bound to localhost by default, stdlib
``http.server`` (no deps).

``bind_runtime_metrics`` joins the host-tier ``madsim_tpu_torch.metrics
.RuntimeMetrics`` shim to the same exposition path: ``num_tasks_by_node``
and ``num_tasks_by_spawn_site`` become pull-time callback gauges, so a
live sim's task census shows up next to the device-tier series.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import Registry


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(labelnames, key, extra=()) -> str:
    pairs = [
        f'{n}="{_escape_label(v)}"' for n, v in zip(labelnames, key)
    ] + list(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _num(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(registry: Registry) -> str:
    """The registry as Prometheus text exposition format v0.0.4."""
    lines = []
    for name, kind, help, labelnames, series in registry.collect():
        if help:
            lines.append(f"# HELP {name} {_escape_help(help)}")
        lines.append(f"# TYPE {name} {kind}")
        if kind == "histogram":
            # registry buckets ride in the series rows:
            # [per-bucket counts..., +Inf count, sum]
            m = registry._metrics.get(name)
            buckets = getattr(m, "buckets", ())
            for key, row in series:
                cum = 0.0
                for b, c in zip(buckets, row):
                    cum += c
                    le = _labels(labelnames, key, (f'le="{_num(b)}"',))
                    lines.append(f"{name}_bucket{le} {_num(cum)}")
                cum += row[len(buckets)]
                le = _labels(labelnames, key, ('le="+Inf"',))
                lines.append(f"{name}_bucket{le} {_num(cum)}")
                lines.append(
                    f"{name}_sum{_labels(labelnames, key)} {_num(row[-1])}"
                )
                lines.append(
                    f"{name}_count{_labels(labelnames, key)} {_num(cum)}"
                )
        else:
            for key, val in series:
                lines.append(f"{name}{_labels(labelnames, key)} {_num(val)}")
    return "\n".join(lines) + "\n"


def bind_runtime_metrics(registry: Registry, metrics) -> None:
    """Expose a host-tier ``RuntimeMetrics`` (madsim_tpu_torch/metrics.py) as
    pull-time gauges: ``madsim_runtime_nodes``, ``madsim_runtime_tasks``,
    ``madsim_runtime_tasks_by_node{node=}``,
    ``madsim_runtime_tasks_by_spawn_site{site=}``."""
    registry.callback_gauge(
        "madsim_runtime_nodes", metrics.num_nodes,
        help="live nodes in the host-tier runtime",
    )
    registry.callback_gauge(
        "madsim_runtime_tasks", metrics.num_tasks,
        help="live tasks in the host-tier runtime",
    )
    registry.callback_gauge(
        "madsim_runtime_tasks_by_node",
        lambda: {str(k): v for k, v in metrics.num_tasks_by_node().items()},
        help="live tasks per node", label="node",
    )
    registry.callback_gauge(
        "madsim_runtime_tasks_by_spawn_site",
        lambda: {
            str(k): v for k, v in metrics.num_tasks_by_spawn_site().items()
        },
        help="live tasks per spawn site", label="site",
    )


class _Handler(BaseHTTPRequestHandler):
    registry: Optional[Registry] = None  # bound per-server subclass

    def do_GET(self):  # noqa: N802 — stdlib API
        if self.path.split("?")[0] not in ("/metrics", "/"):
            self.send_response(404)
            self.end_headers()
            return
        body = render_prometheus(self.registry).encode()
        self.send_response(200)
        self.send_header(
            "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
        )
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-request stderr spam
        pass


class MetricsServer:
    """The opt-in exposition endpoint: ``/metrics`` on a local port,
    served from a daemon thread. ``port=0`` picks a free port (read it
    back from ``.port``)."""

    def __init__(
        self, registry: Registry, port: int = 0, host: str = "127.0.0.1"
    ):
        handler = type("_BoundHandler", (_Handler,), {"registry": registry})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="obs-metrics-http",
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def start_http_server(
    registry: Registry, port: int = 0, host: str = "127.0.0.1"
) -> MetricsServer:
    return MetricsServer(registry, port=port, host=host)
