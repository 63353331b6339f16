"""Reader of the per-layer metric ``suspect_share.etcd``."""

from portbench.metrics._read import suspect_share as read  # noqa: F401
