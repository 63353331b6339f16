"""Compile counting (counterpart of ``madsim_tpu/engine/compiles.py``).

The reference counts XLA compilations through ``jax.log_compiles``, and a
warmed sweep counting 0 there shows that new seeds, candidates or chunk
shapes reuse one compiled program. An eager torch step compiles nothing:
the only compilation the port does is building its hand-written CUDA
kernels (``engine/cuda_build.build``: an ``nvcc`` run, then a ``ctypes``
load, once per kernel and process, cached in ``cuda_build._LIBS``).
``count_compiles()`` compares that module's state at the region's entry
and exit, and counts:

- every ``nvcc`` build (a new ``cuda_build.LOGS`` entry) and every
  library load (a new ``cuda_build._LIBS`` entry) the region performed;
- every graph ``torch.compile`` (dynamo) compiled, when dynamo is in use
  — read from its own counters, without importing it otherwise.

So after a kernel's first use in a process the count is 0 by
construction: ``c.count == 0`` keeps the reference's contract, but in
eager torch it proves only that nothing was rebuilt or recompiled, not
that a program was reused. ``c.events`` lists what was counted, as
``(kind, name)`` pairs.
"""

from __future__ import annotations

import sys
from contextlib import contextmanager

from . import cuda_build


class CompileCounter:
    """Builds, library loads and dynamo graphs seen in one region."""

    def __init__(self):
        self.events: list = []
        self._builds = dict(cuda_build.LOGS)
        self._loads = dict(cuda_build._LIBS)
        self._dynamo_base = _dynamo_graphs()
        self._dynamo_end = None  # frozen when the region closes

    def close(self) -> None:
        for kind, before, after in (
            ("build", self._builds, cuda_build.LOGS),
            ("load", self._loads, cuda_build._LIBS),
        ):
            self.events += [(kind, name) for name, v in after.items()
                            if before.get(name) is not v]
        self._dynamo_end = _dynamo_graphs()

    @property
    def count(self) -> int:
        end = _dynamo_graphs() if self._dynamo_end is None else self._dynamo_end
        return len(self.events) + max(0, end - self._dynamo_base)


def _dynamo_graphs() -> int:
    """Graphs dynamo has compiled in this process (0 when it never ran)."""
    dynamo = sys.modules.get("torch._dynamo.utils")
    if dynamo is None:
        return 0
    return int(dynamo.counters["stats"]["unique_graphs"])


@contextmanager
def count_compiles():
    """``with count_compiles() as c:`` ... after the region, ``c.count``
    is the number of kernel builds, library loads and dynamo graph
    compilations it performed (0 after a proper warm-up)."""
    counter = CompileCounter()
    try:
        yield counter
    finally:
        counter.close()
