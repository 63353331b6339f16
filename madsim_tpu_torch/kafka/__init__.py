"""Kafka simulation — the madsim-rdkafka analogue.

The reference vendors the rust-rdkafka API and swaps its transport for a
simulated broker (madsim-rdkafka/src/sim/, 3.1 kLoC): one global ``Broker``
served over Endpoint connections with a request enum
(sim_broker.rs:14-77). Here:

- :mod:`broker` — topics → partitions → message logs with
  log-end-offsets/watermarks, round-robin produce assignment, timestamp
  lookup, byte-budgeted fetch (broker.rs:80-146)
- :mod:`server` — ``SimBroker().serve(addr)`` node (sim_broker.rs)
- :mod:`client` — ``ClientConfig`` (string map, consumer.rs:70-103),
  ``BaseProducer`` (buffer until flush) / ``FutureProducer``,
  ``BaseConsumer`` (assign/seek/poll) / ``StreamConsumer``,
  ``AdminClient`` (create/delete topics)

- :mod:`wire` — the genuine Kafka binary protocol over the same broker
  (``SimWireServer`` on the sim tier's pipes, ``WireServer`` on the
  shared serving core, ``LegacyWireServer`` on ``real.stream``)
- :mod:`probe` — a minimal wire client (``ProbeClient``) over a real,
  simulated or in-process loopback transport

The wire-vs-broker differential (``fuzz``) is not in this package yet.
"""

from .broker import OwnedMessage, Watermarks
from .client import (
    AdminClient,
    BaseConsumer,
    BaseProducer,
    BaseRecord,
    ClientConfig,
    FutureProducer,
    FutureRecord,
    KafkaError,
    NewTopic,
    StreamConsumer,
    TopicPartitionList,
)
from .server import SimBroker

__all__ = [
    "AdminClient",
    "BaseConsumer",
    "BaseProducer",
    "BaseRecord",
    "ClientConfig",
    "FutureProducer",
    "FutureRecord",
    "KafkaError",
    "NewTopic",
    "OwnedMessage",
    "SimBroker",
    "StreamConsumer",
    "TopicPartitionList",
    "Watermarks",
]
