"""Real-mode signal twin: ``ctrl_c`` over actual OS signals.

The sim's ``signal.ctrl_c`` waits for a simulated ctrl-c delivered by the
supervisor (``Handle.send_ctrl_c``); outside the sim the same call must
wait for a real SIGINT — the reference's std tree gets this for free by
re-exporting tokio's ``signal::ctrl_c``. One shared handler serves ALL
concurrent waiters (the sim twin wakes every waiter too, signal.py), and
it is removed once the last waiter finishes. Caveat: an event loop allows
one SIGINT handler at a time, so while a waiter is pending a host-installed
*loop* handler is superseded; after the last waiter the loop reverts to
Python's default SIGINT behavior (KeyboardInterrupt)."""

from __future__ import annotations

import asyncio
import signal as _signal
from typing import List, Optional

_waiters: List[asyncio.Future] = []
_installed_loop: Optional[asyncio.AbstractEventLoop] = None


def _on_sigint() -> None:
    waiters, _waiters[:] = list(_waiters), []
    for fut in waiters:
        if fut.done() or fut.get_loop().is_closed():
            # a waiter whose runtime was abandoned without cancellation
            # leaves a future bound to a closed loop; resolving it would
            # raise mid-iteration and strand every later live waiter
            continue
        try:
            fut.set_result(None)
        except RuntimeError:
            pass  # loop torn down between the check and the call


async def ctrl_c() -> None:
    """Wait for one SIGINT delivered to this process; every concurrent
    waiter resolves on the same signal."""
    global _installed_loop
    loop = asyncio.get_running_loop()
    fut: asyncio.Future = loop.create_future()
    _waiters.append(fut)
    if _installed_loop is not loop:
        loop.add_signal_handler(_signal.SIGINT, _on_sigint)
        _installed_loop = loop
    try:
        await fut
    finally:
        if fut in _waiters:  # cancelled/timeout before the signal fired
            _waiters.remove(fut)
        if not _waiters and _installed_loop is loop:
            loop.remove_signal_handler(_signal.SIGINT)
            _installed_loop = None
