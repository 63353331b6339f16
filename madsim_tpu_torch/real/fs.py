"""Real-mode filesystem twin: the sim ``fs`` API over actual files.

The reference's std tree wraps real tokio fs (madsim/src/std/fs.rs) so the
same ``fs::File`` code compiles against the OS filesystem outside the sim.
This module is that twin: the surface of ``madsim_tpu_torch.fs`` (File.open/
create/open_or_create, positional read/write, set_len, sync_all, read/
write/metadata/remove_file) backed by real file descriptors, with every
blocking syscall offloaded via ``asyncio.to_thread`` (the analogue of
tokio's blocking-pool offload).

Semantics differences from the sim, by design: there is no crash shadow
state — ``sync_all`` is a real ``fsync`` and durability is the kernel's
business (the sim's power_fail model exists to TEST the code; real mode
runs it). ``remove_file(durable=True)`` additionally fsyncs the parent
directory (the "journaled fs + directory fsync" contract the sim models).
"""

from __future__ import annotations

import asyncio
import os
from typing import Optional


class Metadata:
    def __init__(self, size: int):
        self._size = size

    def len(self) -> int:
        return self._size

    def is_file(self) -> bool:
        return True


class File:
    """Async file handle over a real fd (positional I/O via pread/pwrite,
    so concurrent readers never race a shared cursor — same contract as
    the sim handle)."""

    def __init__(self, fd: int, path: str):
        self._fd: Optional[int] = fd
        self.path = path

    # -- constructors (sim File.open/create/open_or_create) ---------------

    @staticmethod
    async def open(path: str) -> "File":
        fd = await asyncio.to_thread(os.open, str(path), os.O_RDWR)
        return File(fd, str(path))

    @staticmethod
    async def create(path: str) -> "File":
        fd = await asyncio.to_thread(
            os.open, str(path), os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644
        )
        return File(fd, str(path))

    @staticmethod
    async def open_or_create(path: str) -> "File":
        fd = await asyncio.to_thread(
            os.open, str(path), os.O_RDWR | os.O_CREAT, 0o644
        )
        return File(fd, str(path))

    # -- I/O ----------------------------------------------------------------

    def _live(self) -> int:
        if self._fd is None:
            raise ValueError(f"file {self.path!r} is closed")
        return self._fd

    async def read_at(self, buf_len: int, offset: int) -> bytes:
        return await asyncio.to_thread(os.pread, self._live(), buf_len, offset)

    async def read_all(self) -> bytes:
        fd = self._live()

        def _read() -> bytes:
            size = os.fstat(fd).st_size
            return os.pread(fd, size, 0)

        return await asyncio.to_thread(_read)

    async def write_all_at(self, buf: bytes, offset: int) -> None:
        fd = self._live()

        def _write() -> None:
            view = memoryview(bytes(buf))
            pos = offset
            while view:
                n = os.pwrite(fd, view, pos)
                view = view[n:]
                pos += n

        await asyncio.to_thread(_write)

    async def write_all(self, buf: bytes) -> None:
        """Append at end-of-file (the sim's write_all extends the buffer)."""
        fd = self._live()

        def _append() -> None:
            pos = os.fstat(fd).st_size
            view = memoryview(bytes(buf))
            while view:
                n = os.pwrite(fd, view, pos)
                view = view[n:]
                pos += n

        await asyncio.to_thread(_append)

    async def set_len(self, size: int) -> None:
        await asyncio.to_thread(os.ftruncate, self._live(), size)

    async def sync_all(self) -> None:
        await asyncio.to_thread(os.fsync, self._live())

    async def metadata(self) -> Metadata:
        st = await asyncio.to_thread(os.fstat, self._live())
        return Metadata(st.st_size)

    def close(self) -> None:
        fd, self._fd = self._fd, None
        if fd is not None:
            os.close(fd)

    def __del__(self) -> None:  # fd hygiene if the handle is dropped
        try:
            self.close()
        except OSError:
            pass

    async def __aenter__(self) -> "File":
        return self

    async def __aexit__(self, *_exc) -> None:
        self.close()


# -- module-level helpers (sim fs.read/write/metadata/remove_file) ----------


async def read(path: str) -> bytes:
    f = await File.open(path)
    try:
        return await f.read_all()
    finally:
        f.close()


async def write(path: str, data: bytes) -> None:
    f = await File.create(path)
    try:
        await f.write_all(data)
        await f.sync_all()
    finally:
        f.close()


async def metadata(path: str) -> Metadata:
    st = await asyncio.to_thread(os.stat, str(path))
    return Metadata(st.st_size)


async def remove_file(path: str, durable: bool = False) -> None:
    """Unlink; ``durable=True`` also fsyncs the parent directory so the
    unlink itself survives a crash (what the sim's durable flag models)."""

    def _unlink() -> None:
        os.unlink(str(path))
        if durable:
            dirfd = os.open(os.path.dirname(os.path.abspath(str(path))) or ".",
                            os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)

    await asyncio.to_thread(_unlink)
