"""Reader of the per-layer metric ``peak_mem_GiB.etcd``."""

from portbench.metrics._read import peak_mem_gib as read  # noqa: F401
