"""Streaming message adapter (the tonic ``Streaming<T>`` analogue,
madsim-tonic/src/codec.rs).

Wire protocol (madsim-tonic/src/client.rs:33-38): stream bodies travel as
raw messages on the connection; ``()`` — here ``EOS`` — marks end of
stream; a mid-stream server error arrives as an ``("__status__", Status)``
trailer.
"""

from __future__ import annotations

from typing import Any, Optional

from .status import Status

EOS = ("__eos__",)  # end-of-stream marker (the reference's `()` trailer)
ERR = "__status__"


def is_eos(msg: Any) -> bool:
    return isinstance(msg, tuple) and len(msg) == 1 and msg == EOS


def is_err(msg: Any) -> bool:
    return isinstance(msg, tuple) and len(msg) == 2 and msg[0] == ERR


class Streaming:
    """Async iterator over a stream of response messages.

    ``async for msg in stream`` or ``await stream.message()`` (returns
    ``None`` at end of stream — the tonic API shape).
    """

    def __init__(self, rx: Any, close_at_end: bool = False):
        # close_at_end is set on CLIENT-side response streams only: once the
        # stream finishes the whole exchange is over, so the receiver half
        # can be dropped (in real mode this frees the TCP socket).  Server-
        # side request streams share their connection with the pending
        # reply, so they must NOT close it.
        self._rx = rx
        self._done = False
        self._close_at_end = close_at_end

    def _finish(self) -> None:
        self._done = True
        if self._close_at_end:
            close = getattr(self._rx, "close", None)
            if close is not None:
                close()

    async def message(self) -> Optional[Any]:
        if self._done:
            return None
        try:
            msg = await self._rx.recv()
        except ConnectionResetError as e:
            self._done = True
            raise Status.unavailable(str(e) or "connection reset") from None
        if msg is None or is_eos(msg):
            self._finish()
            return None
        if is_err(msg):
            self._finish()
            raise msg[1]
        return msg

    def close(self) -> None:
        """Drop the response stream mid-flight: closes the underlying
        connection half, so the server's next send observes
        BrokenPipeError (the analogue of dropping tonic's ``Streaming``
        — ref tonic-example/tests/test.rs:205-232; explicit because GC
        time is nondeterministic in a determinism framework)."""
        self._done = True
        close = getattr(self._rx, "close", None)
        if close is not None:
            close()

    def __aiter__(self) -> "Streaming":
        return self

    async def __anext__(self) -> Any:
        msg = await self.message()
        if msg is None:
            raise StopAsyncIteration
        return msg
