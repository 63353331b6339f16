"""Reader of the per-layer metric ``handler_ms.raft``."""

from portbench.metrics._read import handler_ms as read  # noqa: F401
