"""Async-runtime façade — the madsim-tokio analogue.

The reference ships a tokio drop-in that re-exports the simulator's
net/time/task/signal, keeps the runtime-agnostic pieces (sync primitives,
macros), and fakes ``runtime::{Builder, Runtime, Handle}`` — ``Runtime``
collects the abort handles of everything it spawned and aborts them all on
shutdown, while ``block_on`` inside a simulation is a hard error
(madsim-tokio/src/lib.rs:38-50, sim/runtime.rs:51-112).

Users porting tokio-shaped Python code get the same shape:

    from madsim_tpu_torch import tokio
    rt = tokio.runtime.Builder().build()
    rt.spawn(worker())          # tracked; aborted on rt.shutdown()
    await tokio.time.sleep(1.0)
    tx, rx = tokio.sync.channel(16)
"""

from __future__ import annotations

from typing import Any, Coroutine, List, Optional

# re-exports, mirroring the façade's module layout (lib.rs:38-50)
from . import fs as fs
from . import net as net
from . import signal as signal
from . import sync as sync
from . import task as task
from . import time as time
from .futures import JoinHandle, join, select
from .task import spawn, spawn_local
from .time import interval, sleep, sleep_until, timeout


class io:
    """``tokio::io`` analogue — REAL asyncio streams.

    The reference's madsim-tokio keeps real tokio ``io`` available even in
    sim mode (madsim-tokio/src/lib.rs:38-50); this namespace is the same
    stance: asyncio's stream machinery re-exported plus a ``copy`` helper.
    Under the simulator there is no asyncio loop, so any await here fails
    loudly ("no running event loop") instead of leaking nondeterminism —
    use the sim ``net``/``fs`` surfaces inside simulations.
    """

    import asyncio as _aio

    StreamReader = _aio.StreamReader
    StreamWriter = _aio.StreamWriter
    open_connection = staticmethod(_aio.open_connection)
    start_server = staticmethod(_aio.start_server)

    @staticmethod
    async def copy(reader: "io.StreamReader", writer: "io.StreamWriter",
                   chunk_size: int = 64 * 1024) -> int:
        """``tokio::io::copy``: pump reader to writer until EOF; returns
        bytes copied."""
        total = 0
        while True:
            chunk = await reader.read(chunk_size)
            if not chunk:
                break
            writer.write(chunk)
            await writer.drain()
            total += len(chunk)
        return total

    @staticmethod
    async def duplex(_max_buf_size: int = 64 * 1024):
        """``tokio::io::duplex``: an in-memory bidirectional pipe as two
        (reader, writer) ends."""
        import asyncio

        a_to_b: asyncio.Queue = asyncio.Queue()
        b_to_a: asyncio.Queue = asyncio.Queue()

        class _End:
            def __init__(self, inbox, outbox):
                self._inbox, self._outbox = inbox, outbox
                self._buf = b""
                self._eof = False

            async def read(self, n: int = -1) -> bytes:
                if not self._buf and not self._eof:
                    chunk = await self._inbox.get()
                    if chunk is None:
                        self._eof = True
                    else:
                        self._buf += chunk
                if n < 0:
                    out, self._buf = self._buf, b""
                else:
                    out, self._buf = self._buf[:n], self._buf[n:]
                return out

            def write(self, data: bytes) -> None:
                self._outbox.put_nowait(bytes(data))

            async def drain(self) -> None:
                pass

            def close(self) -> None:
                self._outbox.put_nowait(None)

        return _End(b_to_a, a_to_b), _End(a_to_b, b_to_a)


class process:
    """``tokio::process`` analogue — REAL subprocesses over asyncio.

    Mirrors ``tokio::process::Command``'s builder shape on top of
    ``asyncio.create_subprocess_exec``. Like ``tokio.io``, this is real
    I/O kept available alongside the sim (madsim-tokio/src/lib.rs:38-50);
    inside the simulator the missing asyncio loop fails any await loudly.
    """

    import asyncio as _aio

    PIPE = _aio.subprocess.PIPE
    STDOUT = _aio.subprocess.STDOUT
    DEVNULL = _aio.subprocess.DEVNULL

    class ExitStatus:
        def __init__(self, code: Optional[int]):
            self._code = code

        def success(self) -> bool:
            return self._code == 0

        def code(self) -> Optional[int]:
            return self._code

        def __repr__(self) -> str:
            return f"ExitStatus({self._code})"

    class Output:
        def __init__(self, status: "process.ExitStatus", stdout: bytes,
                     stderr: bytes):
            self.status = status
            self.stdout = stdout
            self.stderr = stderr

    class Command:
        """``tokio::process::Command``: program + args/env/cwd builder,
        then ``spawn()`` / ``output()`` / ``status()``."""

        def __init__(self, program: str):
            self._program = str(program)
            self._args: List[str] = []
            self._env: Optional[dict] = None
            self._cwd: Optional[str] = None
            self._stdin = None
            self._stdout = None
            self._stderr = None

        def arg(self, a: Any) -> "process.Command":
            self._args.append(str(a))
            return self

        def args(self, it: Any) -> "process.Command":
            self._args.extend(str(a) for a in it)
            return self

        def env(self, key: str, val: str) -> "process.Command":
            if self._env is None:
                import os

                self._env = dict(os.environ)
            self._env[str(key)] = str(val)
            return self

        def env_clear(self) -> "process.Command":
            self._env = {}
            return self

        def current_dir(self, d: str) -> "process.Command":
            self._cwd = str(d)
            return self

        def stdin(self, v: Any) -> "process.Command":
            self._stdin = v
            return self

        def stdout(self, v: Any) -> "process.Command":
            self._stdout = v
            return self

        def stderr(self, v: Any) -> "process.Command":
            self._stderr = v
            return self

        async def spawn(self):
            """Start the child; returns the asyncio subprocess (``Child``
            analogue: .stdin/.stdout/.stderr/.wait()/.kill())."""
            import asyncio

            return await asyncio.create_subprocess_exec(
                self._program,
                *self._args,
                env=self._env,
                cwd=self._cwd,
                stdin=self._stdin,
                stdout=self._stdout,
                stderr=self._stderr,
            )

        async def output(self) -> "process.Output":
            """Run to completion capturing stdout/stderr."""
            import asyncio

            child = await asyncio.create_subprocess_exec(
                self._program,
                *self._args,
                env=self._env,
                cwd=self._cwd,
                stdin=self._stdin,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE,
            )
            out, err = await child.communicate()
            return process.Output(process.ExitStatus(child.returncode), out, err)

        async def status(self) -> "process.ExitStatus":
            child = await self.spawn()
            return process.ExitStatus(await child.wait())


class runtime:
    """Namespace mirroring ``tokio::runtime``."""

    class Builder:
        """Accepts-and-ignores the threading knobs (a simulation is
        single-threaded by construction), builds a tracking Runtime."""

        def __init__(self) -> None:
            pass

        @staticmethod
        def new_multi_thread() -> "runtime.Builder":
            return runtime.Builder()

        @staticmethod
        def new_current_thread() -> "runtime.Builder":
            return runtime.Builder()

        def worker_threads(self, _n: int) -> "runtime.Builder":
            return self

        def thread_name(self, _name: str) -> "runtime.Builder":
            return self

        def thread_stack_size(self, _n: int) -> "runtime.Builder":
            return self

        def enable_all(self) -> "runtime.Builder":
            return self

        def enable_time(self) -> "runtime.Builder":
            return self

        def enable_io(self) -> "runtime.Builder":
            return self

        def build(self) -> "runtime.Runtime":
            return runtime.Runtime()

    class Runtime:
        """Spawn-tracking runtime: every task spawned through it is
        aborted when the runtime shuts down (sim/runtime.rs:51-112)."""

        def __init__(self) -> None:
            self._handles: List[JoinHandle] = []
            self._closed = False

        def spawn(self, coro: Coroutine[Any, Any, Any],
                  name: Optional[str] = None) -> JoinHandle:
            if self._closed:
                coro.close()
                raise RuntimeError("runtime has been shut down")
            handle = spawn(coro, name=name)
            if len(self._handles) >= 64:
                self._handles = [h for h in self._handles if not h.done()]
            self._handles.append(handle)
            return handle

        def block_on(self, _coro: Any) -> Any:
            raise RuntimeError(
                "cannot block_on inside a simulation — spawn the future or "
                "await it (the reference's sim tokio Runtime::block_on is "
                "unimplemented!(), sim/runtime.rs:91-93)"
            )

        def handle(self) -> "runtime.Runtime":
            return self

        def shutdown(self) -> None:
            """Abort everything this runtime spawned (Drop impl)."""
            self._closed = True
            handles, self._handles = self._handles, []
            for h in handles:
                h.abort()

        shutdown_background = shutdown
        shutdown_timeout = lambda self, _t: self.shutdown()  # noqa: E731

        def __enter__(self) -> "runtime.Runtime":
            return self

        def __exit__(self, *_exc: Any) -> None:
            self.shutdown()

    Handle = Runtime


__all__ = [
    "JoinHandle",
    "fs",
    "interval",
    "io",
    "join",
    "net",
    "process",
    "runtime",
    "select",
    "signal",
    "sleep",
    "sleep_until",
    "spawn",
    "spawn_local",
    "sync",
    "task",
    "time",
    "timeout",
]
