"""Future / waker machinery for the deterministic executor.

The reference builds on Rust's ``async-task`` + ``Waker`` protocol; the Python
equivalent here is a minimal trampoline: coroutines ``yield`` *pollable*
objects to the executor, which calls ``pollable.subscribe(task)`` so the task
is re-enqueued (woken) when the pollable resolves.  Spurious wakes are fine —
``__await__`` loops until done, exactly like a Rust future returning
``Poll::Pending``.

Everything awaitable inside the simulation is either a coroutine or derives
from :class:`Future` (one-shot resolvable cell with a waker list).
"""

from __future__ import annotations

from typing import Any, Generator, Iterable, List, Optional, TYPE_CHECKING

if TYPE_CHECKING:
    from .task import Task

_PENDING = object()


class CancelledError(RuntimeError):
    """The awaited task/future was cancelled (tokio ``JoinError::Cancelled``)."""


class JoinError(RuntimeError):
    """Awaited task failed; ``.cause`` holds the original exception."""

    def __init__(self, cause: BaseException):
        self.cause = cause
        super().__init__(f"task panicked: {cause!r}")


class Future:
    """One-shot resolvable value with deterministic FIFO waker list."""

    __slots__ = ("_value", "_exc", "_wakers")

    def __init__(self) -> None:
        self._value: Any = _PENDING
        self._exc: Optional[BaseException] = None
        self._wakers: List["Task"] = []

    # -- state ------------------------------------------------------------

    def done(self) -> bool:
        return self._value is not _PENDING or self._exc is not None

    def result(self) -> Any:
        if self._exc is not None:
            raise self._exc
        if self._value is _PENDING:
            raise RuntimeError("future is not resolved yet")
        return self._value

    def exception(self) -> Optional[BaseException]:
        return self._exc

    def set_result(self, value: Any) -> None:
        if self.done():
            return
        self._value = value
        self._wake_all()

    def set_exception(self, exc: BaseException) -> None:
        if self.done():
            return
        self._exc = exc
        self._wake_all()

    def _reset(self) -> None:
        """Re-arm a resolved future (used by Sleep.reset)."""
        self._value = _PENDING
        self._exc = None

    def _wake_all(self) -> None:
        wakers, self._wakers = self._wakers, []
        for t in wakers:
            t.wake()

    # -- pollable protocol -------------------------------------------------

    def subscribe(self, task: "Task") -> None:
        """Called by the executor when a task blocks on this pollable."""
        # inlined done() — this runs once per executor poll
        if self._value is not _PENDING or self._exc is not None:
            task.wake()
            return
        if task not in self._wakers:
            self._wakers.append(task)

    def __await__(self) -> Generator[Any, None, Any]:
        while self._value is _PENDING and self._exc is None:  # inlined done()
            yield self
        return self.result()


_PyFuture = Future

# Swap in the compiled Future (native/simloop.c) when available: same
# contract (state machine, FIFO wakers, __await__ yields self until
# resolved), with set_result/subscribe/__await__ running in C.  The
# schedule is unchanged — wakers fire in the same order either way.
try:
    from . import native as _native

    _simloop = _native.simloop()
except Exception:  # pragma: no cover - native tier is always optional
    _simloop = None
if _simloop is not None:
    Future = _simloop.Future  # type: ignore[misc]


class JoinHandle(Future):
    """Handle to a spawned task (sim/task/join.rs).

    ``await handle`` returns the task's return value; raises
    :class:`CancelledError` if the task was aborted/killed, or re-raises the
    task's exception if it panicked.  ``abort()`` mirrors tokio's
    ``AbortHandle::abort`` (sets the cancelled flag and wakes the task so the
    executor drops it, sim/task/mod.rs:575-655).
    """

    __slots__ = ("task",)

    def __init__(self, task: "Task"):
        super().__init__()
        self.task = task

    def abort(self) -> None:
        self.task.abort()

    def abort_handle(self) -> "JoinHandle":
        return self

    def is_finished(self) -> bool:
        return self.done()


class _Select:
    """Wait for the first of several pollables to resolve."""

    __slots__ = ("futs",)

    def __init__(self, futs: Iterable[Future]):
        self.futs = list(futs)

    def subscribe(self, task: "Task") -> None:
        for f in self.futs:
            f.subscribe(task)

    def __await__(self) -> Generator[Any, None, Any]:
        while True:
            for i, f in enumerate(self.futs):
                if f.done():
                    return i, f.result()
            yield self


def select(*futs: Future):
    """``await select(a, b, ...)`` -> ``(index, value)`` of the first done.

    Operands must be Future-like (spawn coroutines first).  The analogue of
    ``tokio::select!``; polling order is deterministic (left to right).
    """
    return _Select(futs)


class _Join:
    __slots__ = ("futs",)

    def __init__(self, futs: Iterable[Future]):
        self.futs = list(futs)

    def subscribe(self, task: "Task") -> None:
        for f in self.futs:
            if not f.done():
                f.subscribe(task)
                return

    def __await__(self) -> Generator[Any, None, Any]:
        while not all(f.done() for f in self.futs):
            yield self
        return [f.result() for f in self.futs]


def join(*futs: Future):
    """``await join(a, b, ...)`` -> list of results (tokio ``join!``)."""
    return _Join(futs)


class _PendingForever:
    def subscribe(self, task: "Task") -> None:
        pass

    def __await__(self) -> Generator[Any, None, Any]:
        while True:
            yield self


def pending_forever() -> "_PendingForever":
    """An awaitable that never resolves (``std::future::pending``)."""
    return _PendingForever()
