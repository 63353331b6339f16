"""Reader of the per-layer metric ``step_ms.raft``."""

from portbench.metrics._read import step_ms as read  # noqa: F401
