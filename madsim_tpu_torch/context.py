"""Ambient runtime context (thread-local).

Every public API call (``time.sleep``, ``net.Endpoint.bind``, ``rand.random``)
resolves the ambient handle here, so user code never threads a runtime
reference.  Mirrors the reference's thread-local ``CONTEXT: Handle`` +
``TASK: Arc<TaskInfo>`` (madsim/src/sim/runtime/context.rs:9-80).

One OS thread runs at most one simulation at a time (the seed-sweep driver
spawns one thread per seed, like the reference's builder), so plain
``threading.local`` storage is correct and fast.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import TYPE_CHECKING, Iterator, Optional

if TYPE_CHECKING:
    from .runtime import Handle
    from .task import Task, NodeInfo

_tls = threading.local()


class NoContextError(RuntimeError):
    """Raised when a sim API is used outside a Runtime context."""


def try_current_handle() -> Optional["Handle"]:
    return getattr(_tls, "handle", None)


def current_handle() -> "Handle":
    """The ambient runtime handle (context.rs:14-24 ``context::current``)."""
    h = try_current_handle()
    if h is None:
        raise NoContextError(
            "there is no simulation context; this API must be called "
            "inside Runtime.block_on() (or a @sim_test)"
        )
    return h


def try_current_task() -> Optional["Task"]:
    return getattr(_tls, "task", None)


def current_task() -> "Task":
    t = try_current_task()
    if t is None:
        raise NoContextError("not inside a simulated task")
    return t


def current_node() -> "NodeInfo":
    """Node of the currently running task (context.rs ``current_node``)."""
    return current_task().node


@contextmanager
def enter_handle(handle: "Handle") -> Iterator[None]:
    """Enter a runtime context (context.rs:26-44 ``enter``)."""
    prev = getattr(_tls, "handle", None)
    if prev is not None:
        raise RuntimeError("a simulation runtime is already entered on this thread")
    _tls.handle = handle
    try:
        yield
    finally:
        _tls.handle = prev


@contextmanager
def enter_task(task: "Task") -> Iterator[None]:
    """Enter a task context for one poll (context.rs:58-64 ``enter_task``)."""
    prev = getattr(_tls, "task", None)
    _tls.task = task
    try:
        yield
    finally:
        _tls.task = prev


# Hand-rolled enter/exit pair for the executor's per-poll hot path — the
# @contextmanager generator machinery costs more than the bookkeeping it
# wraps at ~2k polls per simulated seed.

def swap_task(task: "Optional[Task]") -> "Optional[Task]":
    """Set the ambient task, returning the previous one (restore by
    calling again with the return value)."""
    prev = getattr(_tls, "task", None)
    _tls.task = task
    return prev
