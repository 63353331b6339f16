"""Virtual time: mock clock + timer heap + sleep/timeout/interval futures.

Mirrors the reference's ``sim/time/`` tree:
- ``TimeHandle`` / clock-jump loop        -> madsim/src/sim/time/mod.rs:21-230
- base wall time randomized "around 2022" -> time/mod.rs:27-32
- ``advance_to_next_event`` (+50ns eps)   -> time/mod.rs:45-60
- minimum 1 ms sleep (tokio parity)       -> time/mod.rs:110-124
- Sleep future (lazy timer registration)  -> sim/time/sleep.rs:20-55
- Interval + MissedTickBehavior           -> sim/time/interval.rs:38-192
- clock_gettime interposition equivalent  -> madsim_tpu_torch.interpose
                                             (ref: sim/time/system_time.rs)

All internal arithmetic is integer nanoseconds (no float time math — this is
also the invariant that keeps the TPU engine bit-exact, SURVEY.md §7).
Public APIs take float seconds, converted once at the boundary.
"""

from __future__ import annotations

import heapq
from enum import Enum
from typing import Any, Callable, Generator, List, Optional, Tuple

from .context import _tls as _ctx_tls, current_handle
from .futures import Future
from .rand import GlobalRng

NANOS_PER_SEC = 1_000_000_000
MIN_SLEEP_NS = 1_000_000  # 1 ms, tokio parity (time/mod.rs:110-124)
_JUMP_EPSILON_NS = 50  # time/mod.rs:45-60
_EPOCH_2022_S = 1_640_995_200  # 2022-01-01T00:00:00Z


class TimeoutError(Exception):
    """Elapsed deadline from :func:`timeout` (tokio ``Elapsed``)."""


def _to_ns(seconds: float) -> int:
    if seconds < 0:
        raise ValueError("duration must be non-negative")
    return int(round(seconds * NANOS_PER_SEC))


class Instant:
    """Monotonic sim-time point; subtraction gives float seconds."""

    __slots__ = ("ns",)

    def __init__(self, ns: int):
        self.ns = ns

    def __sub__(self, other: "Instant") -> float:
        return (self.ns - other.ns) / NANOS_PER_SEC

    def __add__(self, seconds: float) -> "Instant":
        return Instant(self.ns + _to_ns(seconds))

    def elapsed(self) -> float:
        return current_handle().time.now_instant() - self

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Instant) and self.ns == other.ns

    def __lt__(self, other: "Instant") -> bool:
        return self.ns < other.ns

    def __le__(self, other: "Instant") -> bool:
        return self.ns <= other.ns

    # explicit so `a >= b` doesn't pay Python's reflected-dispatch fallback
    def __gt__(self, other: "Instant") -> bool:
        return self.ns > other.ns

    def __ge__(self, other: "Instant") -> bool:
        return self.ns >= other.ns

    def __hash__(self) -> int:
        return hash(("Instant", self.ns))

    def __repr__(self) -> str:
        return f"Instant({self.ns}ns)"


class _TimerEntry:
    __slots__ = ("deadline_ns", "callback", "cancelled")

    def __init__(self, deadline_ns: int, callback: Callable[[], None]):
        self.deadline_ns = deadline_ns
        self.callback = callback
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class _PyTimerQueue:
    """Default timer queue: heapq of (deadline, seq, entry)."""

    __slots__ = ("_heap", "_seq")

    def __init__(self) -> None:
        self._heap: List[Tuple[int, int, _TimerEntry]] = []
        self._seq = 0

    def push(self, entry: _TimerEntry) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (entry.deadline_ns, self._seq, entry))

    def peek(self) -> Optional[_TimerEntry]:
        while self._heap:
            _d, _s, entry = self._heap[0]
            if entry.cancelled:
                heapq.heappop(self._heap)
                continue
            return entry
        return None

    def pop(self) -> Optional[_TimerEntry]:
        entry = self.peek()
        if entry is not None:
            heapq.heappop(self._heap)
        return entry


class _NativeTimerQueue:
    """Native C++ heap backend (native.TimerHeap) — identical
    (deadline, insertion-seq) ordering, selected with MADSIM_NATIVE=1."""

    __slots__ = ("_heap", "_entries", "_next_id")

    def __init__(self) -> None:
        from .native import TimerHeap

        self._heap = TimerHeap()
        self._entries: dict = {}
        self._next_id = 0

    def push(self, entry: _TimerEntry) -> None:
        self._next_id += 1
        self._entries[self._next_id] = entry
        self._heap.push(entry.deadline_ns, self._next_id)

    def peek(self) -> Optional[_TimerEntry]:
        while True:
            top = self._heap.peek()
            if top is None:
                return None
            entry = self._entries[top[1]]
            if entry.cancelled:
                self._heap.pop()
                del self._entries[top[1]]
                continue
            return entry

    def pop(self) -> Optional[_TimerEntry]:
        if self.peek() is None:
            return None
        _d, id = self._heap.pop()
        return self._entries.pop(id)


def _make_timer_queue():
    import os

    if os.environ.get("MADSIM_NATIVE"):
        from . import native

        if native.available():
            return _NativeTimerQueue()
    return _PyTimerQueue()


class TimeHandle:
    """Virtual clock + binary-heap timer queue (time/mod.rs:21-230)."""

    def __init__(self, rng: GlobalRng):
        # Base wall-clock randomized around 2022 (time/mod.rs:27-32) so no
        # workload can depend on the absolute date.
        self._epoch_ns = (
            _EPOCH_2022_S * NANOS_PER_SEC
            + rng.gen_range(0, 365 * 24 * 3600) * NANOS_PER_SEC
        )
        self._clock_ns = 0  # monotonic ns since sim start
        self._q = _make_timer_queue()
        self._skew = {}  # node id -> (num, den) clock-skew ratio
        rng._now_ns = lambda: self._clock_ns

    # -- per-node clock skew (gray failures, docs/faults.md) --------------
    # The fault supervisor (faults.apply_schedule) registers a
    # skew ratio while a victim's clock-skew window is open; ``sleep``
    # stretches that node's relative waits by num/den, and user code that
    # computes its own deadlines consults ``node_skew()``. The device
    # tier's counterpart is ``engine.faults.skewed_delay``.

    def set_node_skew(self, node_id, num: int, den: int) -> None:
        self._skew[node_id] = (int(num), int(den))

    def clear_node_skew(self, node_id) -> None:
        self._skew.pop(node_id, None)

    def node_skew_of(self, node_id) -> Tuple[int, int]:
        return self._skew.get(node_id, (1, 1))

    # -- clocks -----------------------------------------------------------

    @property
    def now_ns(self) -> int:
        return self._clock_ns

    def now_instant(self) -> Instant:
        return Instant(self._clock_ns)

    def now_time_ns(self) -> int:
        """Simulated wall-clock (UNIX epoch ns) — SystemTime equivalent."""
        return self._epoch_ns + self._clock_ns

    def elapsed(self) -> float:
        return self._clock_ns / NANOS_PER_SEC

    # -- timers -----------------------------------------------------------

    def add_timer_at_ns(
        self, deadline_ns: int, callback: Callable[[], None]
    ) -> _TimerEntry:
        """Register a callback at an absolute monotonic deadline
        (``TimeHandle::add_timer_at``, time/mod.rs:142-153)."""
        entry = _TimerEntry(deadline_ns, callback)
        self._q.push(entry)
        return entry

    def add_timer_ns(self, delay_ns: int, callback: Callable[[], None]) -> _TimerEntry:
        return self.add_timer_at_ns(self._clock_ns + max(0, delay_ns), callback)

    def add_timer(self, delay_s: float, callback: Callable[[], None]) -> _TimerEntry:
        return self.add_timer_ns(_to_ns(delay_s), callback)

    def next_deadline_ns(self) -> Optional[int]:
        entry = self._q.peek()
        return entry.deadline_ns if entry is not None else None

    def _fire_due(self) -> int:
        fired = 0
        while True:
            entry = self._q.peek()
            if entry is None or entry.deadline_ns > self._clock_ns:
                break
            self._q.pop()
            entry.callback()
            fired += 1
        return fired

    def advance_ns(self, delta_ns: int) -> None:
        """Jump the clock forward, firing any timers that become due
        (``time::advance`` / per-poll 50-100ns advance)."""
        clock = self._clock_ns = self._clock_ns + delta_ns
        # fast path: nothing due (runs once per executor poll) — a
        # cancelled head entry compares the same, so skipping is correct
        heap = getattr(self._q, "_heap", None)
        if type(heap) is list:
            if not heap or heap[0][0] > clock:
                return
        self._fire_due()

    def advance(self, seconds: float) -> None:
        self.advance_ns(_to_ns(seconds))

    def advance_to_next_event(self) -> bool:
        """Pop the earliest timer and jump the clock to it (+50 ns epsilon);
        returns False when no timers remain — the deadlock signal
        (time/mod.rs:45-60)."""
        deadline = self.next_deadline_ns()
        if deadline is None:
            return False
        self._clock_ns = max(self._clock_ns, deadline + _JUMP_EPSILON_NS)
        self._fire_due()
        return True


# -- compiled time core (native/simloop.c) ---------------------------------

try:
    from . import native as _native

    _simloop = _native.simloop()
except Exception:  # pragma: no cover - native tier is always optional
    _simloop = None
if _simloop is not None:
    _simloop._configure(Instant)  # lets the C Sleep build .deadline Instants


class _NativeTimeHandle(TimeHandle):
    """TimeHandle over the compiled clock + timer heap (native/simloop.c).

    Identical (deadline, insertion-seq) ordering and jump semantics as the
    Python heapq path — schedules are byte-identical with the core on or
    off (MADSIM_NO_NATIVE=1)."""

    def __init__(self, rng: GlobalRng):
        # same epoch draw as the base class, so the RNG stream is identical
        self._epoch_ns = (
            _EPOCH_2022_S * NANOS_PER_SEC
            + rng.gen_range(0, 365 * 24 * 3600) * NANOS_PER_SEC
        )
        self._core = core = _simloop.Timers()
        self._q = None  # the heap lives in the core
        self._skew = {}  # node id -> (num, den) clock-skew ratio
        rng._now_ns = lambda: core.clock

    @property
    def now_ns(self) -> int:
        return self._core.clock

    def now_instant(self) -> Instant:
        return Instant(self._core.clock)

    def now_time_ns(self) -> int:
        return self._epoch_ns + self._core.clock

    def elapsed(self) -> float:
        return self._core.clock / NANOS_PER_SEC

    def add_timer_at_ns(self, deadline_ns: int, callback: Callable[[], None]):
        return self._core.push(deadline_ns, callback)

    def add_timer_ns(self, delay_ns: int, callback: Callable[[], None]):
        core = self._core
        return core.push(core.clock + max(0, delay_ns), callback)

    def next_deadline_ns(self) -> Optional[int]:
        return self._core.peek_deadline()

    def _fire_due(self) -> int:
        return self._core.fire_due()

    def advance_ns(self, delta_ns: int) -> None:
        self._core.advance_ns(delta_ns)

    def advance_to_next_event(self) -> bool:
        return self._core.advance_to_next_event(_JUMP_EPSILON_NS)


def make_time_handle(rng: GlobalRng) -> TimeHandle:
    """The runtime's TimeHandle factory: compiled core by default,
    pure Python under MADSIM_NO_NATIVE=1 (or MADSIM_NATIVE=1, which
    selects the older ctypes heap instead)."""
    import os

    if _simloop is not None and not os.environ.get("MADSIM_NATIVE"):
        return _NativeTimeHandle(rng)
    return TimeHandle(rng)


# -- Sleep future (sim/time/sleep.rs:20-55) --------------------------------


class Sleep(Future):
    """Resolves when the virtual clock reaches ``deadline``.

    The timer is registered lazily on first poll (subscribe), matching the
    reference's poll-registered waker (sleep.rs:30-44).
    """

    __slots__ = ("_time", "_deadline_ns", "_timer")

    def __init__(self, time: TimeHandle, deadline_ns: int):
        super().__init__()
        self._time = time
        self._deadline_ns = deadline_ns
        self._timer: Optional[_TimerEntry] = None

    @property
    def deadline(self) -> Instant:
        return Instant(self._deadline_ns)

    def is_elapsed(self) -> bool:
        return self.done()

    def subscribe(self, task: Any) -> None:
        if not self.done() and self._timer is None:
            if self._deadline_ns <= self._time.now_ns:
                self.set_result(None)
            else:
                self._timer = self._time.add_timer_at_ns(
                    self._deadline_ns, lambda: self.set_result(None)
                )
        super().subscribe(task)

    def reset(self, deadline: Instant) -> None:
        """Move the deadline (``Sleep::reset``, sleep.rs:47-55)."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._reset()
        self._deadline_ns = deadline.ns
        if self._wakers:
            # tasks are already awaiting: re-arm immediately — they won't be
            # polled again (and so won't re-subscribe) until we fire
            if self._deadline_ns <= self._time.now_ns:
                self.set_result(None)
            else:
                self._timer = self._time.add_timer_at_ns(
                    self._deadline_ns, lambda: self.set_result(None)
                )


def _new_sleep(t: TimeHandle, deadline_ns: int):
    """Sleep factory: the C Sleep on the compiled core, else the Python
    one — same lazy first-subscribe timer arming either way."""
    core = getattr(t, "_core", None)
    if core is not None:
        return _simloop.Sleep(core, deadline_ns)
    return Sleep(t, deadline_ns)


_ns_cache: dict = {}  # duration float -> clamped ns (workloads reuse a few constants)


def sleep(seconds: float) -> Sleep:
    """Sleep for a virtual duration (min 1 ms, tokio parity).

    While the calling task's node is inside a clock-skew window
    (docs/faults.md gray failures), the wait stretches by the registered
    num/den ratio — the node's slow clock measures the duration."""
    # hand-inlined ambient lookup + _to_ns: this is the hottest API call
    # in a typical workload (one per task loop iteration)
    h = getattr(_ctx_tls, "handle", None)
    if h is None:
        current_handle()  # raises NoContextError with the standard message
    ns = _ns_cache.get(seconds)
    if ns is None:
        if seconds < 0:
            raise ValueError("duration must be non-negative")
        ns = int(round(seconds * NANOS_PER_SEC))
        if ns < MIN_SLEEP_NS:
            ns = MIN_SLEEP_NS
        if len(_ns_cache) < 4096:
            _ns_cache[seconds] = ns
    t = h.time
    if t._skew:  # empty dict outside skew windows: one falsy check
        task = getattr(_ctx_tls, "task", None)
        if task is not None:
            f = t._skew.get(task.node.id)
            if f is not None:
                ns = ns * f[0] // f[1]
    core = getattr(t, "_core", None)
    if core is not None:
        return _simloop.Sleep(core, core.clock + ns)
    return Sleep(t, t.now_ns + ns)


def sleep_until(deadline: Instant) -> Sleep:
    t = current_handle().time
    return _new_sleep(t, deadline.ns)


class _InlineTimeout:
    """Drive a coroutine to completion WITHIN the current task, bounded
    by a deadline.

    The reference's ``time::timeout`` polls the inner future inline
    (time/mod.rs:183-196) — it does not spawn it. That matters for error
    flow: an exception raised by the timed coroutine must propagate to
    the awaiter (where a ``try``/``except`` can catch it), not take down
    a separate task (the executor treats an unhandled task exception as
    a panic and aborts the simulation). On expiry the coroutine is
    closed — ``finally`` blocks run, the drop analogue — and
    :class:`TimeoutError` is raised.
    """

    __slots__ = ("_coro", "_sleep", "_cur", "_seconds")

    def __init__(self, coro, sleep_fut: Sleep, seconds: float):
        self._coro = coro
        self._sleep = sleep_fut
        self._cur = None  # pollable the inner coroutine is blocked on
        self._seconds = seconds

    def subscribe(self, task: Any) -> None:
        self._sleep.subscribe(task)
        if self._cur is not None:
            self._cur.subscribe(task)

    def __await__(self):
        # the finally closes the inner coroutine on EVERY exit — timeout,
        # and cancellation (GeneratorExit thrown at the yield when the
        # awaiting task is killed/aborted) — so drop cleanup (finally
        # blocks, BindGuard releases) runs deterministically, not at GC
        # time; close() after normal completion is a no-op
        try:
            while True:
                try:
                    # poll the inner coroutine FIRST (tokio's Timeout
                    # polls the future before the deadline, so an answer
                    # that lands on the deadline instant wins; spurious
                    # re-polls are fine — inner __await__ loops re-yield
                    # while pending)
                    self._cur = self._coro.send(None)
                except StopIteration as stop:
                    return stop.value
                if self._sleep.done():
                    raise TimeoutError(
                        f"deadline has elapsed after {self._seconds}s"
                    )
                yield self
        finally:
            self._coro.close()


async def timeout(seconds: float, awaitable: Any) -> Any:
    """Await ``awaitable`` with a virtual-time deadline.

    Coroutines are polled inline in the current task and closed on
    expiry (the drop analogue; exceptions propagate to the awaiter —
    ``time::timeout``, time/mod.rs:183-196); Future-likes are raced
    directly. Raises :class:`TimeoutError` on expiry.
    """
    import inspect

    from .futures import select

    if inspect.iscoroutine(awaitable):
        return await _InlineTimeout(awaitable, sleep(seconds), seconds)
    idx, value = await select(awaitable, sleep(seconds))
    if idx == 0:
        return value
    raise TimeoutError(f"deadline has elapsed after {seconds}s")


# -- Interval (sim/time/interval.rs:38-192) --------------------------------


class MissedTickBehavior(Enum):
    BURST = "burst"
    DELAY = "delay"
    SKIP = "skip"


class Interval:
    """Periodic ticks with tokio ``MissedTickBehavior`` semantics."""

    def __init__(self, time: TimeHandle, start_ns: int, period_ns: int):
        if period_ns <= 0:
            raise ValueError("interval period must be positive")
        self._time = time
        self._period_ns = period_ns
        self._deadline_ns = start_ns
        self.missed_tick_behavior = MissedTickBehavior.BURST

    @property
    def period(self) -> float:
        return self._period_ns / NANOS_PER_SEC

    async def tick(self) -> Instant:
        await _new_sleep(self._time, self._deadline_ns)
        scheduled = self._deadline_ns
        now = self._time.now_ns
        b = self.missed_tick_behavior
        if b is MissedTickBehavior.BURST:
            self._deadline_ns = scheduled + self._period_ns
        elif b is MissedTickBehavior.DELAY:
            self._deadline_ns = now + self._period_ns
        else:  # SKIP: next multiple of period after now
            missed = (now - scheduled) // self._period_ns + 1
            self._deadline_ns = scheduled + missed * self._period_ns
        return Instant(scheduled)

    def reset(self) -> None:
        self._deadline_ns = self._time.now_ns + self._period_ns


def interval(period: float) -> Interval:
    """First tick completes immediately (tokio ``interval``)."""
    t = current_handle().time
    return Interval(t, t.now_ns, _to_ns(period))


def interval_at(start: Instant, period: float) -> Interval:
    t = current_handle().time
    return Interval(t, start.ns, _to_ns(period))


# -- ambient conveniences --------------------------------------------------


def now_instant() -> Instant:
    h = getattr(_ctx_tls, "handle", None)
    if h is None:
        current_handle()  # raises NoContextError
    t = h.time
    core = getattr(t, "_core", None)
    return Instant(core.clock if core is not None else t._clock_ns)


def now() -> float:
    """Simulated wall-clock time as float UNIX seconds (SystemTime::now)."""
    return current_handle().time.now_time_ns() / NANOS_PER_SEC


def elapsed() -> float:
    """Seconds of virtual time since the simulation started."""
    return current_handle().time.elapsed()


def node_skew() -> "Tuple[int, int]":
    """The current task's node clock-skew ratio ``(num, den)`` — ``(1,
    1)`` outside a skew window. User code that computes its own
    deadlines (rather than sleeping the full duration) applies this to
    the duration, mirroring what ``sleep`` does automatically; see
    ``examples/raft_host.py`` election deadlines."""
    h = getattr(_ctx_tls, "handle", None)
    if h is None:
        current_handle()  # raises NoContextError
    if not h.time._skew:
        return (1, 1)
    task = getattr(_ctx_tls, "task", None)
    if task is None:
        return (1, 1)
    return h.time._skew.get(task.node.id, (1, 1))


def advance(seconds: float) -> None:
    """Manually advance the virtual clock (``time::advance``)."""
    current_handle().time.advance(seconds)
