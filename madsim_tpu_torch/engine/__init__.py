"""The batched simulation engine in PyTorch (counterpart of
``madsim_tpu.engine``). Importing it has no side effects: no device is
touched and no kernel is built until an entry point runs (the kernels
build on their first launch, ``cuda_queue.build``)."""

from .core import (
    EngineConfig,
    EngineState,
    Emits,
    Workload,
    init_sweep,
    run_sweep,
    run_traced,
    step_batch,
    step_one,
)
from .queue import EventQueue
from .stream import stream_sweep

__all__ = [
    "EngineConfig",
    "EngineState",
    "Emits",
    "EventQueue",
    "Workload",
    "init_sweep",
    "run_sweep",
    "run_traced",
    "step_batch",
    "stream_sweep",
]
