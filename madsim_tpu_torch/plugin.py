"""Simulator plugin framework (ref madsim/src/sim/plugin.rs:18-59).

A *simulator* is a pluggable device model (network, filesystem, etcd server,
...) registered on the runtime.  The registry is keyed by class; lookups from
user code resolve through the ambient handle, mirroring the reference's
TypeId-keyed registry + ``plugin::simulator::<S>()`` downcast.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Type, TypeVar

from .context import current_handle

if TYPE_CHECKING:
    from .config import Config
    from .rand import GlobalRng
    from .task import NodeId
    from .time import TimeHandle

S = TypeVar("S", bound="Simulator")


class Simulator:
    """Base class for device simulators (ref ``Simulator`` trait).

    Subclasses get the runtime's rng/time/config at registration
    (``Simulator::new``) and are notified of node lifecycle events.
    """

    def __init__(self, rng: "GlobalRng", time: "TimeHandle", config: "Config"):
        self.rng = rng
        self.time = time
        self.config = config

    def create_node(self, id: "NodeId") -> None:
        """A new node was created (ref plugin.rs:34-36)."""

    def reset_node(self, id: "NodeId") -> None:
        """Node was killed or restarted — drop its state (plugin.rs:38-40)."""


def simulator(cls: Type[S]) -> S:
    """Fetch the registered simulator of type ``cls`` from the ambient
    runtime (ref ``plugin::simulator::<S>()``, plugin.rs:42-54)."""
    return current_handle().simulator(cls)
