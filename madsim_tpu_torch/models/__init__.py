"""Device workload models in PyTorch (counterpart of ``madsim_tpu.models``):
MadRaft (the flagship), etcd, Kafka and S3."""

from . import etcd, kafka, raft, s3  # noqa: F401

__all__ = ["etcd", "kafka", "raft", "s3"]
