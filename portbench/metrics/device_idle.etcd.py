"""Reader of the per-layer metric ``device_idle.etcd``."""

from portbench.metrics._read import device_idle as read  # noqa: F401
