"""Reader of the per-layer metric ``pop_min_roofline.raft``."""

from portbench.metrics._read import pop_min_roofline as read  # noqa: F401
