"""Reader of the per-layer metric ``chunk_sweep_s.etcd``."""

from portbench.metrics._read import chunk_sweep_s as read  # noqa: F401
