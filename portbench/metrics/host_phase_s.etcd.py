"""Reader of the per-layer metric ``host_phase_s.etcd``."""

from portbench.metrics._read import host_phase_s as read  # noqa: F401
