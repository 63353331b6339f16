"""FoundationDB-style cooperative fault injection
(ref madsim/src/sim/buggify.rs:8-32; RNG gate in sim/rand.rs:113-134).

``buggify()`` returns True 25% of the time *when enabled* (disabled by
default); simulator code sprinkles ``if buggify():`` at interesting points
(e.g. the network layer turns a 0-5 µs delay into 1-5 s at 10%,
net/mod.rs:287-295).  Draws flow through the GlobalRng, so they are seeded
and appear in the determinism log.

Scoping: ``enabled()`` is the context-manager form — it turns the gate on
for a ``with`` block and restores the PRIOR state on exit, so a test or an
explore campaign can buggify one section without leaking the gate into
whatever runs next. Re-entrant: each nesting level restores what it saw.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional

from .context import current_handle


def enable() -> None:
    current_handle().rng.buggify_enabled = True


def disable() -> None:
    current_handle().rng.buggify_enabled = False


@contextmanager
def enabled(prob: Optional[float] = None) -> Iterator[None]:
    """Enable buggify for the scope of a ``with`` block, restoring the
    prior gate (and, when ``prob`` is given, the prior default fire
    rate) on exit — exception-safe and re-entrant, so scoped
    buggification composes and never leaks into later tests.

    ``prob`` overrides the fire rate of bare ``buggify()`` calls inside
    the scope (``buggify_with_prob`` keeps taking its explicit value).
    """
    rng = current_handle().rng
    prev_enabled = rng.buggify_enabled
    prev_prob = rng.buggify_prob
    rng.buggify_enabled = True
    if prob is not None:
        rng.buggify_prob = prob
    try:
        yield
    finally:
        rng.buggify_enabled = prev_enabled
        rng.buggify_prob = prev_prob


def is_enabled() -> bool:
    return current_handle().rng.buggify_enabled


def buggify() -> bool:
    """25% chance when enabled, else False (buggify.rs:8-20)."""
    return current_handle().rng.buggify()


def buggify_with_prob(prob: float) -> bool:
    return current_handle().rng.buggify_with_prob(prob)
