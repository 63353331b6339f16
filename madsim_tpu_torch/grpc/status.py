"""gRPC status codes and the Status error (the tonic ``Status`` surface)."""

from __future__ import annotations

from enum import IntEnum


class Code(IntEnum):
    """Canonical gRPC status codes."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class Status(Exception):
    """A gRPC error — raised by clients, returned by handlers that fail.

    Mirrors tonic ``Status`` (constructor-per-code API).
    """

    def __init__(self, code: Code, message: str = ""):
        self.code = Code(code)
        self.message = message
        super().__init__(f"status: {self.code.name}, message: {message!r}")

    def __str__(self) -> str:
        # derived from the fields, not Exception.args, so a Status decoded
        # from the wire (real/codec.py skips __init__) still prints fully
        return f"status: {Code(self.code).name}, message: {self.message!r}"

    # tonic-style constructors ------------------------------------------------

    @classmethod
    def ok(cls, msg: str = "") -> "Status":
        return cls(Code.OK, msg)

    @classmethod
    def cancelled(cls, msg: str = "") -> "Status":
        return cls(Code.CANCELLED, msg)

    @classmethod
    def unknown(cls, msg: str = "") -> "Status":
        return cls(Code.UNKNOWN, msg)

    @classmethod
    def invalid_argument(cls, msg: str = "") -> "Status":
        return cls(Code.INVALID_ARGUMENT, msg)

    @classmethod
    def deadline_exceeded(cls, msg: str = "") -> "Status":
        return cls(Code.DEADLINE_EXCEEDED, msg)

    @classmethod
    def not_found(cls, msg: str = "") -> "Status":
        return cls(Code.NOT_FOUND, msg)

    @classmethod
    def already_exists(cls, msg: str = "") -> "Status":
        return cls(Code.ALREADY_EXISTS, msg)

    @classmethod
    def permission_denied(cls, msg: str = "") -> "Status":
        return cls(Code.PERMISSION_DENIED, msg)

    @classmethod
    def resource_exhausted(cls, msg: str = "") -> "Status":
        return cls(Code.RESOURCE_EXHAUSTED, msg)

    @classmethod
    def failed_precondition(cls, msg: str = "") -> "Status":
        return cls(Code.FAILED_PRECONDITION, msg)

    @classmethod
    def aborted(cls, msg: str = "") -> "Status":
        return cls(Code.ABORTED, msg)

    @classmethod
    def out_of_range(cls, msg: str = "") -> "Status":
        return cls(Code.OUT_OF_RANGE, msg)

    @classmethod
    def unimplemented(cls, msg: str = "") -> "Status":
        return cls(Code.UNIMPLEMENTED, msg)

    @classmethod
    def internal(cls, msg: str = "") -> "Status":
        return cls(Code.INTERNAL, msg)

    @classmethod
    def unavailable(cls, msg: str = "") -> "Status":
        return cls(Code.UNAVAILABLE, msg)

    @classmethod
    def data_loss(cls, msg: str = "") -> "Status":
        return cls(Code.DATA_LOSS, msg)

    @classmethod
    def unauthenticated(cls, msg: str = "") -> "Status":
        return cls(Code.UNAUTHENTICATED, msg)
