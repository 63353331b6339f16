"""Reader of the per-layer metric ``occupancy.etcd``."""

from portbench.metrics._phase import chunk_occupancy as read  # noqa: F401
