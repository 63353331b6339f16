"""Restricted binary codec for real-mode network frames.

Replaces pickle on the wire (a pickled frame from an untrusted peer is
remote code execution; the reference's std transport uses typed bincode,
madsim/src/std/net/tcp.rs:42-327, which can only materialize the types the
program declared). This codec is the Python analogue of that property:

- plain data (None, bool, int, float, str, bytes, tuple, list, dict)
  round-trips structurally;
- user-defined objects decode ONLY if their class is a registered RPC
  ``Request`` subclass (auto-registered by ``Request.__init_subclass__``)
  or explicitly ``register()``-ed. Decoding never imports anything and
  never calls ``__init__``/``__reduce__`` — an unknown class name raises
  ``CodecError``, and a known one is rebuilt via ``__new__`` + ``__dict__``
  update with plain-data fields only.

Integers are arbitrary precision (length-prefixed two's-complement), so
u64 RPC ids and tags round-trip exactly.
"""

from __future__ import annotations

import struct
from enum import Enum
from typing import Any, Dict

from ..net import rpc as _rpc


class CodecError(Exception):
    """Malformed frame or disallowed type."""


_EXTRA_TYPES: Dict[str, type] = {}


def register(cls: type) -> type:
    """Explicitly allow a non-Request class on the wire (decorator-friendly).
    Instances are encoded as their ``__dict__`` of plain data; ``Enum``
    subclasses are encoded by member name (decoded via ``cls[name]``, never
    by constructing)."""
    if not issubclass(cls, Enum) and getattr(cls, "__dictoffset__", 0) == 0:
        raise CodecError(
            f"cannot register {cls.__qualname__}: its instances have no "
            "__dict__ (__slots__ class?) — the codec round-trips objects "
            "through their instance dict"
        )
    _EXTRA_TYPES[f"{cls.__module__}::{cls.__qualname__}"] = cls
    return cls


def _lookup(name: str) -> type:
    cls = _EXTRA_TYPES.get(name)
    if cls is None:
        # Request subclasses register themselves at class-creation time
        # (net/rpc.py) — a live registry, never an import
        cls = _rpc.request_types().get(name)
    if cls is None:
        raise CodecError(f"refusing to decode unregistered type {name!r}")
    return cls


# type tags
_NONE, _TRUE, _FALSE = b"N", b"T", b"F"
_INT, _FLOAT, _STR, _BYTES = b"i", b"f", b"s", b"b"
_TUPLE, _LIST, _DICT, _OBJ, _ENUM = b"t", b"l", b"d", b"O", b"E"

_MAX_DEPTH = 32


def _enc(obj: Any, out: bytearray, depth: int) -> None:
    if depth > _MAX_DEPTH:
        raise CodecError("structure too deeply nested")
    if obj is None:
        out += _NONE
    elif obj is True:
        out += _TRUE
    elif obj is False:
        out += _FALSE
    elif isinstance(obj, Enum):
        # checked before int so IntEnum members (e.g. grpc Code) keep
        # their type across the wire instead of flattening to int
        cls = type(obj)
        name = f"{cls.__module__}::{cls.__qualname__}"
        _lookup(name)  # refuse to encode unregistered enums too
        raw, member = name.encode(), obj.name.encode()
        out += _ENUM + struct.pack(">I", len(raw)) + raw
        out += struct.pack(">I", len(member)) + member
    elif isinstance(obj, int):
        raw = obj.to_bytes((obj.bit_length() + 8) // 8 or 1, "big", signed=True)
        out += _INT + struct.pack(">I", len(raw)) + raw
    elif isinstance(obj, float):
        out += _FLOAT + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode()
        out += _STR + struct.pack(">I", len(raw)) + raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out += _BYTES + struct.pack(">I", len(raw)) + raw
    elif isinstance(obj, tuple):
        out += _TUPLE + struct.pack(">I", len(obj))
        for item in obj:
            _enc(item, out, depth + 1)
    elif isinstance(obj, list):
        out += _LIST + struct.pack(">I", len(obj))
        for item in obj:
            _enc(item, out, depth + 1)
    elif isinstance(obj, dict):
        out += _DICT + struct.pack(">I", len(obj))
        for k, v in obj.items():
            _enc(k, out, depth + 1)
            _enc(v, out, depth + 1)
    else:
        cls = type(obj)
        name = f"{cls.__module__}::{cls.__qualname__}"
        _lookup(name)  # refuse to *encode* unregistered types too
        fields = getattr(obj, "__dict__", None)
        if fields is None:
            raise CodecError(
                f"cannot encode {cls.__qualname__}: instance has no "
                "__dict__ (__slots__ class?)"
            )
        raw = name.encode()
        out += _OBJ + struct.pack(">I", len(raw)) + raw
        _enc(dict(fields), out, depth + 1)


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise CodecError("truncated frame")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]


def _dec(r: _Reader, depth: int) -> Any:
    if depth > _MAX_DEPTH:
        raise CodecError("structure too deeply nested")
    tag = r.take(1)
    if tag == _NONE:
        return None
    if tag == _TRUE:
        return True
    if tag == _FALSE:
        return False
    if tag == _INT:
        return int.from_bytes(r.take(r.u32()), "big", signed=True)
    if tag == _FLOAT:
        return struct.unpack(">d", r.take(8))[0]
    if tag == _STR:
        return r.take(r.u32()).decode()
    if tag == _BYTES:
        return r.take(r.u32())
    if tag == _TUPLE:
        return tuple(_dec(r, depth + 1) for _ in range(r.u32()))
    if tag == _LIST:
        return [_dec(r, depth + 1) for _ in range(r.u32())]
    if tag == _DICT:
        n = r.u32()
        out = {}
        for _ in range(n):
            k = _dec(r, depth + 1)
            out[k] = _dec(r, depth + 1)
        return out
    if tag == _ENUM:
        name = r.take(r.u32()).decode()
        cls = _lookup(name)
        if not (isinstance(cls, type) and issubclass(cls, Enum)):
            raise CodecError(f"{name!r} is not a registered Enum")
        member = r.take(r.u32()).decode()
        try:
            return cls[member]
        except KeyError:
            raise CodecError(f"{name!r} has no member {member!r}") from None
    if tag == _OBJ:
        name = r.take(r.u32()).decode()
        cls = _lookup(name)
        fields = _dec(r, depth + 1)
        if not isinstance(fields, dict):
            raise CodecError("object fields must decode to a dict")
        if issubclass(cls, BaseException):
            # object.__new__ refuses exception types; BaseException.__new__
            # allocates without running any user __init__/__new__
            obj = BaseException.__new__(cls)
        else:
            obj = object.__new__(cls)
        obj.__dict__.update(fields)
        return obj
    raise CodecError(f"unknown type tag {tag!r}")


def dumps(obj: Any) -> bytes:
    out = bytearray()
    _enc(obj, out, 0)
    return bytes(out)


def loads(data: bytes) -> Any:
    """Decode one frame; ANY malformed input raises ``CodecError`` (hostile
    bytes must not leak UnicodeDecodeError/TypeError/... to callers)."""
    try:
        r = _Reader(bytes(data))
        obj = _dec(r, 0)
        if r.pos != len(r.data):
            raise CodecError("trailing bytes after frame")
        return obj
    except CodecError:
        raise
    except Exception as e:
        raise CodecError(f"malformed frame: {type(e).__name__}: {e}") from e
