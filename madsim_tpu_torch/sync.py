"""Async synchronization primitives for the deterministic executor.

The reference keeps real tokio ``sync`` in sim mode (madsim-tokio/src/lib.rs:
38-50) because tokio's channels are runtime-agnostic.  Our executor has its
own Future protocol, so we provide the tokio ``sync`` surface natively:
oneshot, mpsc (bounded/unbounded), watch, broadcast, Notify, Semaphore,
Mutex, RwLock, Barrier.  All waiter queues are FIFO lists — deterministic
wake order, with *scheduling* randomness injected only by the executor's
random ready-queue pop.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, Generic, List, Optional, Tuple, TypeVar

from .futures import Future

T = TypeVar("T")


class ChannelClosedError(Exception):
    """Send/recv on a closed channel (tokio ``SendError``/``RecvError``)."""


class LaggedError(Exception):
    """Broadcast receiver fell behind and missed messages."""

    def __init__(self, n: int):
        self.missed = n
        super().__init__(f"broadcast receiver lagged by {n} messages")


# -- oneshot ---------------------------------------------------------------


class OneshotSender(Generic[T]):
    def __init__(self, fut: Future):
        self._fut = fut

    def send(self, value: T) -> None:
        if self._fut.done():
            raise ChannelClosedError("oneshot value already sent")
        self._fut.set_result(value)

    def is_closed(self) -> bool:
        return self._fut.done()


def oneshot() -> Tuple[OneshotSender, Future]:
    """tokio ``oneshot::channel`` — receiver is awaitable directly."""
    fut: Future = Future()
    return OneshotSender(fut), fut


# -- mpsc ------------------------------------------------------------------


class _MpscState(Generic[T]):
    def __init__(self, capacity: Optional[int]):
        self.queue: Deque[T] = deque()
        self.capacity = capacity
        self.closed = False
        self.recv_waiters: List[Future] = []
        self.send_waiters: List[Future] = []

    def wake_one_recv(self) -> None:
        while self.recv_waiters:
            fut = self.recv_waiters.pop(0)
            if not fut.done():
                fut.set_result(None)
                return

    def wake_one_send(self) -> None:
        while self.send_waiters:
            fut = self.send_waiters.pop(0)
            if not fut.done():
                fut.set_result(None)
                return

    def wake_all(self) -> None:
        for fut in self.recv_waiters + self.send_waiters:
            if not fut.done():
                fut.set_result(None)
        self.recv_waiters.clear()
        self.send_waiters.clear()


class Sender(Generic[T]):
    def __init__(self, state: _MpscState[T]):
        self._state = state

    async def send(self, value: T) -> None:
        s = self._state
        while True:
            if s.closed:
                raise ChannelClosedError("channel closed")
            if s.capacity is None or len(s.queue) < s.capacity:
                s.queue.append(value)
                s.wake_one_recv()
                return
            fut: Future = Future()
            s.send_waiters.append(fut)
            await fut

    def try_send(self, value: T) -> None:
        s = self._state
        if s.closed:
            raise ChannelClosedError("channel closed")
        if s.capacity is not None and len(s.queue) >= s.capacity:
            raise ChannelClosedError("channel full")
        s.queue.append(value)
        s.wake_one_recv()

    def send_nowait(self, value: T) -> None:
        """Unbounded-style synchronous send (UnboundedSender::send)."""
        s = self._state
        if s.closed:
            raise ChannelClosedError("channel closed")
        s.queue.append(value)
        s.wake_one_recv()

    def close(self) -> None:
        self._state.closed = True
        self._state.wake_all()

    def is_closed(self) -> bool:
        return self._state.closed


class Receiver(Generic[T]):
    def __init__(self, state: _MpscState[T]):
        self._state = state

    async def recv(self) -> Optional[T]:
        """Next value, or ``None`` once closed and drained (tokio parity)."""
        s = self._state
        while True:
            if s.queue:
                v = s.queue.popleft()
                s.wake_one_send()
                return v
            if s.closed:
                return None
            fut: Future = Future()
            s.recv_waiters.append(fut)
            await fut

    def try_recv(self) -> Optional[T]:
        s = self._state
        if s.queue:
            v = s.queue.popleft()
            s.wake_one_send()
            return v
        if s.closed:
            raise ChannelClosedError("channel closed")
        return None

    def close(self) -> None:
        self._state.closed = True
        self._state.wake_all()

    def __len__(self) -> int:
        return len(self._state.queue)


def channel(capacity: int) -> Tuple[Sender, Receiver]:
    s: _MpscState = _MpscState(capacity)
    return Sender(s), Receiver(s)


def unbounded_channel() -> Tuple[Sender, Receiver]:
    s: _MpscState = _MpscState(None)
    return Sender(s), Receiver(s)


# -- watch -----------------------------------------------------------------


class _WatchState(Generic[T]):
    def __init__(self, value: T):
        self.value = value
        self.version = 0
        self.waiters: List[Future] = []


class WatchSender(Generic[T]):
    def __init__(self, state: _WatchState[T]):
        self._state = state

    def send(self, value: T) -> None:
        s = self._state
        s.value = value
        s.version += 1
        waiters, s.waiters = s.waiters, []
        for fut in waiters:
            fut.set_result(None)

    def borrow(self) -> T:
        return self._state.value


class WatchReceiver(Generic[T]):
    def __init__(self, state: _WatchState[T]):
        self._state = state
        self._seen = state.version

    def borrow(self) -> T:
        return self._state.value

    def borrow_and_update(self) -> T:
        self._seen = self._state.version
        return self._state.value

    async def changed(self) -> None:
        s = self._state
        while s.version == self._seen:
            fut: Future = Future()
            s.waiters.append(fut)
            await fut
        self._seen = s.version

    def clone(self) -> "WatchReceiver[T]":
        r: WatchReceiver[T] = WatchReceiver(self._state)
        r._seen = self._seen
        return r


def watch(initial: T) -> Tuple[WatchSender, WatchReceiver]:
    s: _WatchState = _WatchState(initial)
    return WatchSender(s), WatchReceiver(s)


# -- broadcast -------------------------------------------------------------


class _BroadcastState:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.receivers: List["BroadcastReceiver"] = []
        self.closed = False


class BroadcastSender(Generic[T]):
    def __init__(self, state: _BroadcastState):
        self._state = state

    def send(self, value: T) -> int:
        n = 0
        for r in self._state.receivers:
            r._push(value)
            n += 1
        return n

    def subscribe(self) -> "BroadcastReceiver[T]":
        r: BroadcastReceiver[T] = BroadcastReceiver(self._state)
        self._state.receivers.append(r)
        return r

    def close(self) -> None:
        self._state.closed = True
        for r in self._state.receivers:
            r._wake()


class BroadcastReceiver(Generic[T]):
    def __init__(self, state: _BroadcastState):
        self._state = state
        self._queue: Deque[T] = deque()
        self._lagged = 0
        self._waiters: List[Future] = []

    def _push(self, value: T) -> None:
        if len(self._queue) >= self._state.capacity:
            self._queue.popleft()
            self._lagged += 1
        self._queue.append(value)
        self._wake()

    def _wake(self) -> None:
        waiters, self._waiters = self._waiters, []
        for fut in waiters:
            fut.set_result(None)

    async def recv(self) -> T:
        while True:
            if self._lagged:
                n, self._lagged = self._lagged, 0
                raise LaggedError(n)
            if self._queue:
                return self._queue.popleft()
            if self._state.closed:
                raise ChannelClosedError("broadcast channel closed")
            fut: Future = Future()
            self._waiters.append(fut)
            await fut


def broadcast(capacity: int) -> Tuple[BroadcastSender, BroadcastReceiver]:
    s = _BroadcastState(capacity)
    tx: BroadcastSender = BroadcastSender(s)
    return tx, tx.subscribe()


# -- Notify ----------------------------------------------------------------


class Notify:
    def __init__(self) -> None:
        self._permit = False
        self._waiters: List[Future] = []

    async def notified(self) -> None:
        if self._permit:
            self._permit = False
            return
        fut: Future = Future()
        self._waiters.append(fut)
        await fut

    def notify_one(self) -> None:
        while self._waiters:
            fut = self._waiters.pop(0)
            if not fut.done():
                fut.set_result(None)
                return
        self._permit = True

    def notify_waiters(self) -> None:
        waiters, self._waiters = self._waiters, []
        for fut in waiters:
            fut.set_result(None)


# -- Semaphore / Mutex / RwLock / Barrier ----------------------------------


class Semaphore:
    def __init__(self, permits: int):
        self._permits = permits
        self._waiters: List[Future] = []

    @property
    def available_permits(self) -> int:
        return self._permits

    async def acquire(self, n: int = 1) -> "SemaphoreGuard":
        while self._permits < n:
            fut: Future = Future()
            self._waiters.append(fut)
            await fut
        self._permits -= n
        return SemaphoreGuard(self, n)

    def try_acquire(self, n: int = 1) -> Optional["SemaphoreGuard"]:
        if self._permits < n:
            return None
        self._permits -= n
        return SemaphoreGuard(self, n)

    def release(self, n: int = 1) -> None:
        self._permits += n
        waiters, self._waiters = self._waiters, []
        for fut in waiters:
            fut.set_result(None)


class SemaphoreGuard:
    def __init__(self, sem: Semaphore, n: int):
        self._sem: Optional[Semaphore] = sem
        self._n = n

    def release(self) -> None:
        if self._sem is not None:
            sem, self._sem = self._sem, None
            sem.release(self._n)

    def __enter__(self) -> "SemaphoreGuard":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


class Mutex:
    """Async mutex: ``async with mutex: ...``"""

    def __init__(self) -> None:
        self._sem = Semaphore(1)

    async def __aenter__(self) -> None:
        self._guard = await self._sem.acquire()

    async def __aexit__(self, *exc: Any) -> None:
        self._guard.release()

    async def lock(self) -> SemaphoreGuard:
        return await self._sem.acquire()


class RwLock:
    """Write-preferring async RwLock."""

    def __init__(self) -> None:
        self._readers = 0
        self._writer = False
        self._write_waiting = 0
        self._waiters: List[Future] = []

    def _wake_all(self) -> None:
        waiters, self._waiters = self._waiters, []
        for fut in waiters:
            fut.set_result(None)

    async def read(self) -> "_RwReadGuard":
        while self._writer or self._write_waiting:
            fut: Future = Future()
            self._waiters.append(fut)
            await fut
        self._readers += 1
        return _RwReadGuard(self)

    async def write(self) -> "_RwWriteGuard":
        self._write_waiting += 1
        try:
            while self._writer or self._readers:
                fut: Future = Future()
                self._waiters.append(fut)
                await fut
        finally:
            self._write_waiting -= 1
        self._writer = True
        return _RwWriteGuard(self)


class _RwReadGuard:
    def __init__(self, lock: RwLock):
        self._lock = lock

    def release(self) -> None:
        if self._lock is not None:
            lock, self._lock = self._lock, None  # type: ignore[assignment]
            lock._readers -= 1
            if lock._readers == 0:
                lock._wake_all()

    def __enter__(self) -> "_RwReadGuard":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


class _RwWriteGuard:
    def __init__(self, lock: RwLock):
        self._lock = lock

    def release(self) -> None:
        if self._lock is not None:
            lock, self._lock = self._lock, None  # type: ignore[assignment]
            lock._writer = False
            lock._wake_all()

    def __enter__(self) -> "_RwWriteGuard":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


class Barrier:
    def __init__(self, n: int):
        if n < 1:
            raise ValueError("barrier size must be >= 1")
        self._n = n
        self._count = 0
        self._generation = 0
        self._waiters: List[Future] = []

    async def wait(self) -> bool:
        """Returns True for the leader (last arriver), tokio parity."""
        gen = self._generation
        self._count += 1
        if self._count == self._n:
            self._count = 0
            self._generation += 1
            waiters, self._waiters = self._waiters, []
            for fut in waiters:
                fut.set_result(None)
            return True
        while self._generation == gen:
            fut: Future = Future()
            self._waiters.append(fut)
            await fut
        return False
