"""Reader of the per-layer metric ``occupancy.raft``."""

from portbench.metrics._read import occupancy as read  # noqa: F401
