"""PyTorch/CUDA port of the batched simulation engine (``madsim_tpu``).

The JAX package ``madsim_tpu`` is the reference: every function here is
held to it bit for bit (the engine is integer-only, so parity is exact).
This package imports ``torch`` and numpy only — never ``jax`` and nothing
of ``madsim_tpu``.

Layout mirrors the reference: ``engine/`` (rng, ops, queue, core, net,
faults, checkpoint, the streaming lane pool ``stream``, the pop-min and
megasweep CUDA kernels), ``models/`` (raft, etcd, kafka, s3), ``oracle/``
(the history decoder, the sequential specs, the WGL checker and the
device screens behind ``checked_sweep``), ``parallel/`` (the seed mesh:
sharded sweeps over ``torch.distributed`` ranks, and ``World``, which
spawns them), ``explore/`` (the coverage-guided campaign loop: targets,
triage, shrink, campaign, fleet, the steered scheduler, the fleet store
and orchestrator, and the device half of the host↔device differential),
``replay`` (the cross-tier replay helpers) and ``entry`` (a one-step
check and the multi-rank dry run).

The host tier sits beside it at the reference's module names: ``rand``
(the seeded ``GlobalRng`` and the determinism log), ``time``, ``task``
(the single-threaded executor on virtual time), ``runtime`` (``Runtime``,
``Handle``, ``NodeBuilder``), ``interpose`` (the stdlib's randomness and
clocks routed to the simulation), ``net`` and ``fs`` (the network and
disk simulators), ``sync``, ``buggify``, ``signal``, ``builder``
(``Builder``, ``@sim_test``, the ``MADSIM_TEST_*`` variables), ``faults``
(``compile_host`` and the host fault supervisor) and ``examples`` (the
host-tier raft workload). It runs on the CPU by design and imports
numpy only; its names are exported here as the reference exports them.

Every entry point takes ``device=None``; ``None`` means CUDA and raises
when no GPU is present — it never falls back to the CPU. Pass
``device="cpu"`` explicitly to run the plain torch path on the host.

``torch`` is imported where a device is resolved, not by importing the
package: the checker's pool workers (``oracle/check.py``) start as fresh
interpreters that import ``madsim_tpu_torch.oracle.check``, and they stay
numpy-only, as does every host-tier module.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from . import buggify as buggify
from . import fs as fs
from . import rand as rand
from . import signal as signal
from . import sync as sync
from . import time as time
from . import tracing as tracing
from .builder import Builder, main, sim_test
from .context import current_handle, current_node, current_task
from .futures import Future, JoinHandle, join, pending_forever, select
from .runtime import Handle, NodeBuilder, Runtime, init_logger
from .task import NodeId, exit_current_task, spawn, spawn_local
from .time import Instant, TimeoutError, interval, sleep, sleep_until, timeout

if TYPE_CHECKING:
    import torch

__all__ = [
    "Builder",
    "Future",
    "Handle",
    "Instant",
    "JoinHandle",
    "NodeBuilder",
    "NodeId",
    "Runtime",
    "TimeoutError",
    "buggify",
    "current_handle",
    "current_node",
    "current_task",
    "exit_current_task",
    "fs",
    "init_logger",
    "interval",
    "join",
    "main",
    "pending_forever",
    "rand",
    "resolve_device",
    "select",
    "signal",
    "sim_test",
    "sleep",
    "sleep_until",
    "spawn",
    "spawn_local",
    "sync",
    "time",
    "timeout",
    "tracing",
]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``cuda``, which
    must be available (no silent CPU fallback)."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "madsim_tpu_torch runs on CUDA by default and no GPU is "
                "available; pass device='cpu' to run the plain torch path"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is unavailable")
    return dev
