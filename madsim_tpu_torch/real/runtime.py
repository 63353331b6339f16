"""Real-mode runtime: asyncio event loop behind the sim API shape."""

from __future__ import annotations

import asyncio
import inspect
from typing import Any, Callable, Coroutine, Union


class JoinHandle:
    """asyncio.Task behind the sim JoinHandle surface."""

    def __init__(self, task: asyncio.Task):
        self._task = task

    def done(self) -> bool:
        return self._task.done()

    def is_finished(self) -> bool:
        return self._task.done()

    def abort(self) -> None:
        self._task.cancel()

    def abort_handle(self) -> "JoinHandle":
        return self

    def result(self) -> Any:
        return self._task.result()

    def __await__(self):
        return self._task.__await__()


def spawn(coro: Coroutine[Any, Any, Any], name: str = None) -> JoinHandle:
    """Real ``task::spawn`` (ref std/mod.rs re-exports tokio spawn)."""
    return JoinHandle(asyncio.get_running_loop().create_task(coro, name=name))


spawn_local = spawn


class Runtime:
    """Real runtime: ``block_on`` = asyncio.run (ref std twin)."""

    def __init__(self, seed: int = None, config: Any = None):
        # seed/config accepted for signature parity; real mode ignores them
        pass

    def block_on(
        self,
        main: Union[Coroutine[Any, Any, Any], Callable[[], Coroutine[Any, Any, Any]]],
    ) -> Any:
        coro = main() if callable(main) and not inspect.iscoroutine(main) else main
        return asyncio.run(coro)
