"""Real-mode time: wall clock behind the sim time API shape."""

from __future__ import annotations

import asyncio
import time as _time
from typing import Any


class TimeoutError(Exception):  # same name as the sim's (tokio Elapsed)
    pass


class Instant:
    __slots__ = ("ns",)

    def __init__(self, ns: int):
        self.ns = ns

    def __sub__(self, other: "Instant") -> float:
        return (self.ns - other.ns) / 1e9

    def __add__(self, seconds: float) -> "Instant":
        return Instant(self.ns + int(seconds * 1e9))

    def elapsed(self) -> float:
        return now_instant() - self

    def __lt__(self, other: "Instant") -> bool:
        return self.ns < other.ns

    def __le__(self, other: "Instant") -> bool:
        return self.ns <= other.ns


def now_instant() -> Instant:
    return Instant(_time.monotonic_ns())


def now() -> float:
    return _time.time()


def elapsed() -> float:
    return _time.monotonic()


async def sleep(seconds: float) -> None:
    await asyncio.sleep(seconds)


async def sleep_until(deadline: Instant) -> None:
    await asyncio.sleep(max(0.0, deadline - now_instant()))


async def timeout(seconds: float, awaitable: Any) -> Any:
    try:
        return await asyncio.wait_for(awaitable, seconds)
    except asyncio.TimeoutError:
        raise TimeoutError(f"deadline has elapsed after {seconds}s") from None


class Interval:
    def __init__(self, period: float):
        self._period = period
        self._next = _time.monotonic() + period

    async def tick(self) -> Instant:
        delay = self._next - _time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        scheduled = self._next
        self._next = scheduled + self._period
        return Instant(int(scheduled * 1e9))


def interval(period: float) -> Interval:
    iv = Interval(period)
    iv._next = _time.monotonic()  # first tick immediate, tokio parity
    return iv
