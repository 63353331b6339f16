"""Generic gRPC client: the four call shapes + interceptors + timeouts.

Mirrors madsim-tonic ``client::Grpc`` (client.rs:39-219). The wire exchange
per call (client.rs:33-38):

    head:  (path, server_streaming, Request)       client -> server
    body:  raw messages then EOS                   (client-streaming calls)
    reply: ("ok", Response) | ("err", Status)      server -> client
    body:  raw messages then EOS                   (server-streaming calls)

Transport failures surface as ``Status.unavailable`` (the reference maps
broken connections the same way — a killed server mid-call yields
"broken pipe" on send and Unavailable on the next call,
tonic-example/tests/test.rs:234-278).
"""

from __future__ import annotations

from typing import Any, AsyncIterable, Callable, Dict, Iterable, Optional, Tuple, Union

from .. import task as mstask
from .. import time as mstime
from .channel import Channel
from .codec import EOS, Streaming, is_err, is_eos
from .status import Status


class Request:
    """A request envelope: message + metadata + optional timeout (the
    tonic ``Request<T>`` with grpc-timeout metadata support)."""

    def __init__(self, message: Any = None, metadata: Optional[Dict[str, str]] = None,
                 timeout: Optional[float] = None):
        self.message = message
        self.metadata: Dict[str, str] = dict(metadata or {})
        if timeout is not None:
            self.set_timeout(timeout)

    def set_timeout(self, seconds: float) -> None:
        # encoded like the grpc-timeout header so interceptors can see it
        self.metadata["grpc-timeout"] = f"{int(seconds * 1000)}m"

    def timeout(self) -> Optional[float]:
        v = self.metadata.get("grpc-timeout")
        if v is None:
            return None
        unit = v[-1]
        n = float(v[:-1])
        return n * {"H": 3600, "M": 60, "S": 1, "m": 1e-3, "u": 1e-6, "n": 1e-9}[unit]

    def get_ref(self) -> Any:
        return self.message

    def into_inner(self) -> Any:
        return self.message

    @staticmethod
    def wrap(msg: Any) -> "Request":
        return msg if isinstance(msg, Request) else Request(msg)


class Response:
    """The response envelope (tonic ``Response<T>``)."""

    def __init__(self, message: Any = None, metadata: Optional[Dict[str, str]] = None):
        self.message = message
        self.metadata: Dict[str, str] = dict(metadata or {})

    def get_ref(self) -> Any:
        return self.message

    def into_inner(self) -> Any:
        return self.message


Interceptor = Callable[[Request], Request]


async def _feed(tx: Any, messages: Union[Iterable, AsyncIterable]) -> None:
    """Send a client-side request stream then the EOS trailer."""
    try:
        if hasattr(messages, "__aiter__"):
            async for m in messages:
                await tx.send(m)
        else:
            for m in messages:
                await tx.send(m)
        await tx.send(EOS)
    except BrokenPipeError:
        pass  # server went away; the reply read surfaces the error


class Grpc:
    """The generic caller; typed clients (service.py) wrap this.

    The executor bindings are class attributes so the real-mode twin
    (real/grpc.py) can swap sim spawn/timeout for asyncio ones while
    reusing every call shape unchanged — the analogue of the reference
    compiling the same tonic surface with or without ``--cfg madsim``.
    """

    _spawn = staticmethod(mstask.spawn)
    _timeout = staticmethod(mstime.timeout)
    _timeout_error: type = mstime.TimeoutError

    def __init__(self, channel: Channel, interceptor: Optional[Interceptor] = None):
        self.channel = channel
        self.interceptor = interceptor

    def with_interceptor(self, f: Interceptor) -> "Grpc":
        return type(self)(self.channel, f)  # keep real-mode subclass bindings

    def _prepare(self, request: Request) -> Request:
        if self.interceptor is not None:
            request = self.interceptor(request)
        if request.timeout() is None and self.channel.default_timeout is not None:
            request.set_timeout(self.channel.default_timeout)
        return request

    async def _call(self, path: str, request: Request, server_streaming: bool,
                    body: Optional[Union[Iterable, AsyncIterable]]) -> Tuple[Any, Any]:
        """One exchange; returns (reply_head, rx)."""
        try:
            tx, rx = await self.channel.open_stream()
        except (ConnectionError, OSError) as e:
            raise Status.unavailable(f"transport error: {e}") from None
        try:
            try:
                await tx.send((path, server_streaming, request))
            except BrokenPipeError as e:
                raise Status.unavailable(f"broken pipe: {e}") from None
            if body is not None:
                self._spawn(_feed(tx, body), name=f"grpc-feed {path}")
            else:
                tx.close()
            try:
                head = await rx.recv()
            except ConnectionResetError as e:
                raise Status.unavailable(str(e) or "connection reset") from None
            if head is None:
                raise Status.unavailable("connection closed before response")
            return head, rx
        except BaseException:
            # error OR cancellation (e.g. a grpc-timeout cancelling this
            # call mid-await): drop both halves so the real-mode socket is
            # freed instead of leaking until GC
            tx.close()
            rx.close()
            raise

    async def _call_timeout(self, path: str, request: Request,
                            server_streaming: bool, body) -> Tuple[Any, Any]:
        timeout_s = request.timeout()
        if timeout_s is None:
            return await self._call(path, request, server_streaming, body)
        try:
            return await self._timeout(
                timeout_s, self._call(path, request, server_streaming, body)
            )
        except self._timeout_error:
            raise Status.cancelled("Timeout expired") from None

    @staticmethod
    def _unwrap(head: Any) -> Response:
        kind, payload = head
        if kind == "err":
            raise payload
        return payload

    # -- the four call shapes (client.rs:52-219) ---------------------------

    async def unary(self, path: str, request: Union[Request, Any]) -> Response:
        request = self._prepare(Request.wrap(request))
        head, rx = await self._call_timeout(path, request, False, None)
        try:
            return self._unwrap(head)
        finally:
            rx.close()  # exchange complete; frees the real-mode socket

    async def client_streaming(
        self, path: str, messages: Union[Iterable, AsyncIterable],
        request: Optional[Request] = None,
    ) -> Response:
        request = self._prepare(request or Request())
        head, rx = await self._call_timeout(path, request, False, messages)
        try:
            return self._unwrap(head)
        finally:
            rx.close()

    async def server_streaming(
        self, path: str, request: Union[Request, Any]
    ) -> Streaming:
        request = self._prepare(Request.wrap(request))
        head, rx = await self._call_timeout(path, request, True, None)
        try:
            self._unwrap(head)
        except BaseException:
            rx.close()
            raise
        return Streaming(rx, close_at_end=True)

    async def streaming(
        self, path: str, messages: Union[Iterable, AsyncIterable],
        request: Optional[Request] = None,
    ) -> Streaming:
        request = self._prepare(request or Request())
        head, rx = await self._call_timeout(path, request, True, messages)
        try:
            self._unwrap(head)
        except BaseException:
            rx.close()
            raise
        return Streaming(rx, close_at_end=True)
