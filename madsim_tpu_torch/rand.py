"""Deterministic global RNG — the *only* source of randomness in a simulation.

Mirrors the reference's ``GlobalRng`` (madsim/src/sim/rand.rs:28-135): a seeded
counter-based generator behind the runtime handle; every draw in the entire
simulation (scheduler pops, time jitter, network latency/loss, buggify, user
``rand.random()`` calls) flows through it, which is what makes one seed = one
bit-exact execution.

Where the reference uses Xoshiro256++ plus ``#[no_mangle]`` libc interposition
of getrandom/getentropy (rand.rs:197-260), we use numpy's Philox counter-based
bit generator (stable across platforms/versions by numpy's stream-compat
policy) plus Python-level interposition of the stdlib ``random``/``uuid``
modules (see madsim_tpu_torch.interpose).

Determinism log/check (rand.rs:64-88): with logging enabled, every draw
appends ``mix64(value ^ sim_time_ns)`` to a log; a second run with checking
enabled compares draw-by-draw and raises ``NondeterminismError`` with the sim
timestamp at the first divergence.
"""

from __future__ import annotations

from typing import Any, List, MutableSequence, Optional, Sequence, TypeVar

import numpy as np

from .context import _tls as _ctx_tls, current_handle

T = TypeVar("T")

_MASK64 = (1 << 64) - 1


def mix64(x: int) -> int:
    """splitmix64 finalizer — stable 64-bit hash used for the determinism log."""
    x &= _MASK64
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
    return x ^ (x >> 31)


class NondeterminismError(RuntimeError):
    """Raised by the determinism checker at the first divergent RNG draw."""

    def __init__(self, sim_time_ns: int, draw_index: int):
        self.sim_time_ns = sim_time_ns
        self.draw_index = draw_index
        super().__init__(
            f"non-determinism detected at simulated time "
            f"{sim_time_ns / 1e9:.9f}s (rng draw #{draw_index}); "
            f"the workload consumed randomness differently between two runs "
            f"of the same seed"
        )


# One numpy refill per this many draws; the refill bound and the refill
# size MUST stay equal or draws would silently repeat or skip the buffer
# tail.
_BUF_SIZE = 1024


class GlobalRng:
    """Seeded deterministic RNG + determinism log/check + buggify gate.

    Reference: ``GlobalRng::{new_with_seed, with, enable_log, enable_check,
    buggify}`` (madsim/src/sim/rand.rs:28-135).
    """

    def __init__(self, seed: int):
        self.seed = int(seed) & _MASK64
        self._gen = np.random.Generator(np.random.Philox(key=self.seed))
        # buffered draws: one numpy call per _BUF_SIZE values — a per-draw
        # Generator.integers() call costs ~8 µs of numpy dispatch and was
        # ~25% of host-tier wall time; the batched stream is identical
        # for a given seed (the determinism contract is per-seed
        # reproducibility, which buffering preserves)
        self._buf = None
        self._buf_pos = 0
        # determinism log/check state
        self._log: Optional[List[int]] = None
        self._check: Optional[List[int]] = None
        self._check_pos = 0
        self._draw_count = 0
        # buggify (sim/buggify.rs; gate lives in rand.rs:113-134 in the ref)
        self.buggify_enabled = False
        self.buggify_prob = 0.25  # default fire rate of bare buggify()
        # set by TimeHandle so log entries carry sim time
        self._now_ns = lambda: 0

    # -- determinism log / check (rand.rs:64-88) --------------------------

    def enable_log(self) -> None:
        self._log = []

    def take_log(self) -> Optional[List[int]]:
        log, self._log = self._log, None
        return log

    def enable_check(self, log: List[int]) -> None:
        self._check = log
        self._check_pos = 0

    def _record(self, value: int) -> None:
        self._draw_count += 1
        if self._log is None and self._check is None:
            return
        digest = mix64(value ^ self._now_ns())
        if self._log is not None:
            self._log.append(digest)
        if self._check is not None:
            pos = self._check_pos
            self._check_pos += 1
            if pos >= len(self._check) or self._check[pos] != digest:
                raise NondeterminismError(self._now_ns(), self._draw_count - 1)

    # -- raw draws --------------------------------------------------------

    def next_u64(self) -> int:
        pos = self._buf_pos
        buf = self._buf
        if buf is None or pos >= _BUF_SIZE:
            # .tolist() once per refill: indexing a Python list yields ints
            # directly, vs a numpy scalar + int() conversion per draw
            buf = self._buf = self._gen.integers(
                0, 1 << 64, size=_BUF_SIZE, dtype=np.uint64
            ).tolist()
            pos = 0
        self._buf_pos = pos + 1
        v = buf[pos]
        if self._log is None and self._check is None:
            self._draw_count += 1  # inlined _record fast path
        else:
            self._record(v)
        return v

    def next_u32(self) -> int:
        return self.next_u64() >> 32

    def random(self) -> float:
        """Uniform float in [0, 1) with 53 bits of entropy."""
        return (self.next_u64() >> 11) * (1.0 / (1 << 53))

    # -- derived draws ----------------------------------------------------

    def gen_range(self, low: int, high: int) -> int:
        """Uniform integer in [low, high) — rejection-free Lemire reduction."""
        if high <= low:
            raise ValueError(f"empty range [{low}, {high})")
        span = high - low
        return low + (self.next_u64() * span >> 64)

    def uniform(self, low: float, high: float) -> float:
        return low + (high - low) * self.random()

    def randbool(self, p: float = 0.5) -> bool:
        return self.random() < p

    def shuffle(self, seq: MutableSequence[Any]) -> None:
        # Fisher-Yates with our draws so it lands in the determinism log.
        for i in range(len(seq) - 1, 0, -1):
            j = self.gen_range(0, i + 1)
            seq[i], seq[j] = seq[j], seq[i]

    def choice(self, seq: Sequence[T]) -> T:
        if not seq:
            raise IndexError("choice from empty sequence")
        return seq[self.gen_range(0, len(seq))]

    def sample_bytes(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            out += self.next_u64().to_bytes(8, "little")
        return bytes(out[:n])

    # -- buggify gate (sim/buggify.rs:8-32, gate in rand.rs:113-134) ------

    def buggify_with_prob(self, prob: float) -> bool:
        if not self.buggify_enabled:
            return False
        return self.random() < prob

    def buggify(self) -> bool:
        return self.buggify_with_prob(self.buggify_prob)


# -- ambient-context convenience API (rand.rs thread_rng/random) ----------


def rng() -> GlobalRng:
    """The current simulation's RNG (reference ``thread_rng``)."""
    # hand-inlined ambient lookup (hot: every module-level draw)
    h = getattr(_ctx_tls, "handle", None)
    if h is None:
        return current_handle().rng  # raises NoContextError
    return h.rng


def random() -> float:
    return rng().random()


def next_u64() -> int:
    return rng().next_u64()


def next_u32() -> int:
    return rng().next_u32()


def gen_range(low: int, high: int) -> int:
    return rng().gen_range(low, high)


def uniform(low: float, high: float) -> float:
    return rng().uniform(low, high)


def shuffle(seq: MutableSequence[Any]) -> None:
    rng().shuffle(seq)


def choice(seq: Sequence[T]) -> T:
    return rng().choice(seq)


def getrandom(n: int) -> bytes:
    """Deterministic entropy — the analogue of the libc ``getrandom``
    interposition (rand.rs:197-241)."""
    return rng().sample_bytes(n)
