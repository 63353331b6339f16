"""Simulated ctrl-c / signal handling (ref madsim/src/sim/signal.rs:4-9 and
task/mod.rs:106-111,166-175,419-434).

The first ``await ctrl_c()`` on a node installs a handler; from then on
``Handle.send_ctrl_c(node)`` resolves the pending waiters instead of killing
the node.
"""

from __future__ import annotations

from .context import current_node
from .futures import Future


async def ctrl_c() -> None:
    """Wait for a simulated ctrl-c on the current node."""
    node = current_node()
    node.ctrl_c_installed = True
    fut: Future = Future()
    node.ctrl_c_waiters.append(fut)
    await fut
