"""Reader of the per-layer metric ``kernels_per_step.raft``."""

from portbench.metrics._read import kernels_per_step as read  # noqa: F401
