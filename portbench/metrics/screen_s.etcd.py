"""Reader of the per-layer metric ``screen_s.etcd``."""

from portbench.metrics._phase import screen_s as read  # noqa: F401
