"""Simulated per-node filesystem (ref madsim/src/sim/fs.rs:24-257).

Each node has an in-memory file table ``path -> INode``.  Crash semantics
are a deliberate strengthening of the reference (whose ``power_fail`` is a
TODO stub, fs.rs:50-53): *every* mutation — writes, truncation by
``File.create`` over an existing path, and ``remove_file`` — is buffered in
a per-inode shadow state until ``sync_all``; node kill/restart triggers
``power_fail``, which discards unsynced data: dirty buffers are dropped,
never-synced files disappear, and unsynced removals are resurrected.
``remove_file(durable=True)`` opts into an immediately-durable unlink
(the "journaled fs + directory fsync" model).

Gray failures (docs/faults.md): a fault schedule can open a *slow-disk
window* on a node (``FsSim.stall_fsync``/``unstall_fsync``) during which
``sync_all`` defers — the call returns but nothing becomes durable until
the window closes; the schedule's ``power_fail`` action drives
``FsSim.power_fail`` directly, so crash-without-sync is a first-class
campaign fault rather than a side effect of kill.
"""

from __future__ import annotations

from typing import Dict, Optional

from .context import current_node
from .plugin import Simulator, simulator
from .task import NodeId


class _INode:
    __slots__ = ("synced", "dirty", "removed", "sync_requested",
                 "remove_requested")

    def __init__(self, durable: bool = False) -> None:
        # synced=None => the file has never been made durable
        self.synced: Optional[bytearray] = bytearray() if durable else None
        self.dirty: Optional[bytearray] = None  # copy-on-write until sync
        self.removed = False  # unsynced unlink tombstone
        # slow-disk bookkeeping (fsync-stall windows, engine/faults.py
        # gray failures): a sync issued while the node's disk is stalled
        # defers — the flag marks it pending so ``unstall_fsync`` can
        # apply it; a durable unlink issued while stalled likewise defers
        # its directory fsync
        self.sync_requested = False
        self.remove_requested = False

    def data(self) -> bytearray:
        if self.dirty is not None:
            return self.dirty
        if self.synced is not None:
            return self.synced
        return bytearray()

    def for_write(self) -> bytearray:
        if self.dirty is None:
            self.dirty = bytearray(self.synced or b"")
        return self.dirty

    def sync(self) -> None:
        self.removed = False
        self.sync_requested = False
        self.remove_requested = False
        if self.dirty is not None:
            self.synced = self.dirty
            self.dirty = None
        elif self.synced is None:
            self.synced = bytearray()

    def power_fail(self) -> bool:
        """Drop unsynced state; returns False if the inode itself vanishes
        (it was never synced)."""
        self.dirty = None
        self.removed = False
        self.sync_requested = False
        self.remove_requested = False
        return self.synced is not None


class FsSim(Simulator):
    """Filesystem simulator plugin (ref ``FsSim``, fs.rs:24-96)."""

    def __init__(self, rng, time, config):
        super().__init__(rng, time, config)
        self._nodes: Dict[NodeId, Dict[str, _INode]] = {}
        self._fsync_stalled: set = set()  # nodes inside a slow-disk window

    def create_node(self, id: NodeId) -> None:
        self._nodes.setdefault(id, {})

    def reset_node(self, id: NodeId) -> None:
        self.power_fail(id)

    def _table(self, id: NodeId) -> Dict[str, _INode]:
        return self._nodes.setdefault(id, {})

    def power_fail(self, id: NodeId) -> None:
        """Crash the node's storage back to its last-synced state
        (ref fs.rs:50-53, implemented here)."""
        table = self._table(id)
        for path in list(table):
            if not table[path].power_fail():
                del table[path]

    # -- slow-disk windows (gray failures, docs/faults.md) -----------------

    def fsync_stalled(self, id: NodeId) -> bool:
        return id in self._fsync_stalled

    def stall_fsync(self, id: NodeId) -> None:
        """Open a slow-disk window: syncs issued on the node defer (the
        write cache absorbs them — nothing becomes durable) until
        ``unstall_fsync``. A power fail inside the window drops them."""
        self._fsync_stalled.add(id)

    def unstall_fsync(self, id: NodeId) -> None:
        """Close the window: the disk catches up — every deferred sync
        applies, deferred durable unlinks finalize."""
        self._fsync_stalled.discard(id)
        table = self._table(id)
        for path in list(table):
            inode = table[path]
            if inode.remove_requested:
                del table[path]
            elif inode.sync_requested and not inode.removed:
                inode.sync()

    def get_file_size(self, id: NodeId, path: str) -> int:
        inode = self._table(id).get(str(path))
        if inode is None or inode.removed:
            raise FileNotFoundError(path)
        return len(inode.data())


def _fs() -> FsSim:
    return simulator(FsSim)


def _node_table() -> Dict[str, _INode]:
    return _fs()._table(current_node().id)


def _lookup(path: str) -> _INode:
    inode = _node_table().get(str(path))
    if inode is None or inode.removed:
        raise FileNotFoundError(path)
    return inode


class File:
    """Async file handle (ref ``fs::File``, fs.rs:98-220)."""

    def __init__(self, inode: _INode, path: str):
        self._inode = inode
        self.path = path

    @staticmethod
    async def open(path: str) -> "File":
        return File(_lookup(path), str(path))

    @staticmethod
    async def create(path: str) -> "File":
        """Create or truncate; the truncation is buffered until sync_all,
        so a crash before sync restores the previous durable contents."""
        table = _node_table()
        inode = table.get(str(path))
        if inode is None:
            inode = _INode()
            table[str(path)] = inode
        inode.removed = False
        # re-creating the path supersedes any deferred durable unlink
        # (else unstall_fsync would delete the re-created file)
        inode.remove_requested = False
        inode.dirty = bytearray()
        return File(inode, str(path))

    @staticmethod
    async def open_or_create(path: str) -> "File":
        table = _node_table()
        inode = table.get(str(path))
        if inode is None or inode.removed:
            if inode is None:
                inode = _INode()
                table[str(path)] = inode
            inode.removed = False
            inode.remove_requested = False
            inode.dirty = bytearray()
        return File(inode, str(path))

    async def read_at(self, buf_len: int, offset: int) -> bytes:
        data = self._inode.data()
        return bytes(data[offset : offset + buf_len])

    async def read_all(self) -> bytes:
        return bytes(self._inode.data())

    async def write_all_at(self, buf: bytes, offset: int) -> None:
        data = self._inode.for_write()
        end = offset + len(buf)
        if len(data) < end:
            data.extend(b"\x00" * (end - len(data)))
        data[offset:end] = buf

    async def write_all(self, buf: bytes) -> None:
        self._inode.for_write().extend(buf)

    async def set_len(self, size: int) -> None:
        data = self._inode.for_write()
        if size <= len(data):
            del data[size:]
        else:
            data.extend(b"\x00" * (size - len(data)))

    async def sync_all(self) -> None:
        # inside a slow-disk window the sync defers: the call returns (the
        # lying write cache) but durability is pending — a power fail
        # before the window closes drops the data (docs/faults.md)
        if _fs().fsync_stalled(current_node().id):
            self._inode.sync_requested = True
        else:
            self._inode.sync()

    async def metadata(self) -> "Metadata":
        return Metadata(len(self._inode.data()))


class Metadata:
    def __init__(self, size: int):
        self._size = size

    def len(self) -> int:
        return self._size

    def is_file(self) -> bool:
        return True


async def read(path: str) -> bytes:
    """ref ``fs::read`` (fs.rs:230-240)."""
    f = await File.open(path)
    return await f.read_all()


async def write(path: str, data: bytes) -> None:
    f = await File.create(path)
    await f.write_all(data)
    await f.sync_all()


async def metadata(path: str) -> Metadata:
    f = await File.open(path)
    return await f.metadata()


async def remove_file(path: str, durable: bool = False) -> None:
    """Unlink.  By default the removal is buffered (a crash before any
    subsequent sync resurrects the file); ``durable=True`` = unlink +
    directory fsync."""
    table = _node_table()
    inode = table.get(str(path))
    if inode is None or inode.removed:
        raise FileNotFoundError(path)
    if durable and _fs().fsync_stalled(current_node().id):
        # the directory fsync defers with the rest of the stalled disk:
        # tombstone now, finalize at unstall — a power fail in between
        # resurrects the file, exactly like a buffered removal
        inode.removed = True
        inode.dirty = None
        inode.remove_requested = True
    elif durable or inode.synced is None:
        del table[str(path)]
    else:
        inode.removed = True
        inode.dirty = None
