"""Native runtime core: lazy g++/gcc build + bindings (counterpart of
``madsim_tpu/native``).

Two libraries are built from the sources beside this file at first use,
into the git-ignored ``madsim_tpu_torch/_build/native/`` (never into the
package directory):

- ``_simcore`` (``simcore.cpp``, plain C ABI via ctypes, g++): the older
  timer heap and ready queue (selected with ``MADSIM_NATIVE=1``) and the
  threefry-2x32 block the device engine draws from;
- ``_simloop`` (``simloop.c``, a CPython extension, gcc against
  ``Python.h``): the compiled executor core — ``Future``, ``Sleep``,
  ``Timers`` and the ready ``Loop`` — which ``time``, ``task`` and
  ``futures`` take by default.

A library's file name carries a hash of its source, the compile command
and the interpreter, so an edited source is rebuilt and an identical
build is loaded as it is. Builds go to a pid-suffixed temp file renamed
into place, so concurrent first builders (forked procs children, xdist
workers) never see a half-written library. ``available()`` and
``simloop()`` report whether each tier loaded; ``build_error()`` returns
the compiler's output of a failed build. Every consumer has a
pure-Python fallback, and ``MADSIM_NO_NATIVE=1`` forces it.

The swap is *schedule-transparent*: the native TimerHeap orders by
(deadline, insertion seq) exactly like the Python heapq path, and the
ReadyQueue only executes swap-removes at indices drawn from the Python
GlobalRng — same draws, same order, same schedules.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import time
from typing import Dict, Optional, Sequence

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build", "native")
_SRC = os.path.join(_DIR, "simcore.cpp")
_SIMLOOP_SRC = os.path.join(_DIR, "simloop.c")

#: seconds of each build made in this process, by library name
BUILD_SECONDS: Dict[str, float] = {}
_ERRORS: Dict[str, str] = {}

_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _target(name: str, cmd_prefix: list, src: str) -> str:
    """The library's path: its name tagged with a hash of the source, the
    compile command and the interpreter and platform it is built on."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(cmd_prefix).encode())
    h.update(f"{sys.version}|{platform.platform()}".encode())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def _compile_atomic(name: str, cmd_prefix: list, src: str, dst: str) -> bool:
    """Compile to a pid-suffixed temp file, then os.rename into place.

    Concurrent first-builders (forked procs-sweep children, parallel pytest
    workers) would otherwise interleave compiler writes into the same .so
    and leave a corrupt artifact behind; rename is atomic, so a concurrent
    loader sees either no file or the complete new one."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{dst}.tmp.{os.getpid()}"
    t = time.perf_counter()
    try:
        proc = subprocess.run(
            cmd_prefix + [src, "-o", tmp], capture_output=True, text=True, timeout=120
        )
        if proc.returncode != 0:
            _ERRORS[name] = f"{' '.join(cmd_prefix)} failed:\n{proc.stdout}{proc.stderr}"
            return False
        os.rename(tmp, dst)
        BUILD_SECONDS[name] = time.perf_counter() - t
        return True
    except Exception as e:  # compiler missing or timed out
        _ERRORS[name] = f"{' '.join(cmd_prefix)}: {e!r}"
        return False
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


_SIMCORE_CMD = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed or os.environ.get("MADSIM_NO_NATIVE"):
        return None
    so = _target("_simcore", _SIMCORE_CMD, _SRC)
    if not os.path.exists(so) and not _compile_atomic("_simcore", _SIMCORE_CMD, _SRC, so):
        _load_failed = True  # don't re-run a failing compile per Runtime
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        _ERRORS["_simcore"] = f"loading {so}: {e}"
        _load_failed = True
        return None
    u64, i64, u32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_uint32
    p = ctypes.POINTER
    lib.timer_heap_new.restype = ctypes.c_void_p
    lib.timer_heap_free.argtypes = [ctypes.c_void_p]
    lib.timer_heap_push.argtypes = [ctypes.c_void_p, i64, u64]
    lib.timer_heap_peek.argtypes = [ctypes.c_void_p, p(i64), p(u64)]
    lib.timer_heap_pop.argtypes = [ctypes.c_void_p, p(i64), p(u64)]
    lib.timer_heap_len.argtypes = [ctypes.c_void_p]
    lib.timer_heap_len.restype = u64
    lib.ready_queue_new.restype = ctypes.c_void_p
    lib.ready_queue_free.argtypes = [ctypes.c_void_p]
    lib.ready_queue_push.argtypes = [ctypes.c_void_p, u64]
    lib.ready_queue_len.argtypes = [ctypes.c_void_p]
    lib.ready_queue_len.restype = u64
    lib.ready_queue_swap_remove.argtypes = [ctypes.c_void_p, u64]
    lib.ready_queue_swap_remove.restype = u64
    lib.threefry2x32.argtypes = [u32, u32, u32, u32, p(u32), p(u32)]
    lib.threefry2x32_batch.argtypes = [u32, u32, p(u32), p(u32), u64]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """The compiler's (or loader's) output of a failed native build in
    this process, or None when nothing failed."""
    if not _ERRORS:
        return None
    return "\n".join(f"[{name}] {msg}" for name, msg in sorted(_ERRORS.items()))


class TimerHeap:
    """Native (deadline, seq)-ordered timer heap; callbacks stay in Python
    keyed by the u64 id."""

    __slots__ = ("_h", "_lib")

    def __init__(self) -> None:
        self._lib = _load()
        assert self._lib is not None, "native simcore unavailable"
        self._h = self._lib.timer_heap_new()

    def __del__(self) -> None:
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_h", None):
            lib.timer_heap_free(self._h)
            self._h = None

    def push(self, deadline_ns: int, id: int) -> None:
        self._lib.timer_heap_push(self._h, deadline_ns, id)

    def peek(self) -> Optional[tuple]:
        d, i = ctypes.c_int64(), ctypes.c_uint64()
        if not self._lib.timer_heap_peek(self._h, ctypes.byref(d), ctypes.byref(i)):
            return None
        return d.value, i.value

    def pop(self) -> Optional[tuple]:
        d, i = ctypes.c_int64(), ctypes.c_uint64()
        if not self._lib.timer_heap_pop(self._h, ctypes.byref(d), ctypes.byref(i)):
            return None
        return d.value, i.value

    def __len__(self) -> int:
        return self._lib.timer_heap_len(self._h)


class ReadyQueue:
    """Native swap-remove vector (ref mpsc try_recv_random)."""

    __slots__ = ("_q", "_lib")

    def __init__(self) -> None:
        self._lib = _load()
        assert self._lib is not None, "native simcore unavailable"
        self._q = self._lib.ready_queue_new()

    def __del__(self) -> None:
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_q", None):
            lib.ready_queue_free(self._q)
            self._q = None

    def push(self, id: int) -> None:
        self._lib.ready_queue_push(self._q, id)

    def swap_remove(self, idx: int) -> int:
        return self._lib.ready_queue_swap_remove(self._q, idx)

    def __len__(self) -> int:
        return self._lib.ready_queue_len(self._q)


def threefry2x32(k0: int, k1: int, c0: int, c1: int) -> tuple:
    """One JAX-compatible Threefry-2x32 block (for native replay of
    device-engine draws)."""
    lib = _load()
    assert lib is not None, "native simcore unavailable"
    o0, o1 = ctypes.c_uint32(), ctypes.c_uint32()
    lib.threefry2x32(k0, k1, c0, c1, ctypes.byref(o0), ctypes.byref(o1))
    return o0.value, o1.value


def threefry2x32_batch(k0: int, k1: int, counters: Sequence[int]) -> list:
    """Threefry-2x32 blocks of one key over ``n`` counter pairs in one
    native call: ``counters`` holds ``c0, c1`` interleaved (``2n`` words),
    the result the ``2n`` output words ``o0, o1`` interleaved."""
    lib = _load()
    assert lib is not None, "native simcore unavailable"
    n = len(counters) // 2
    ctr = (ctypes.c_uint32 * (2 * n))(*counters)
    out = (ctypes.c_uint32 * (2 * n))()
    lib.threefry2x32_batch(k0, k1, ctr, out, n)
    return list(out)


def fold_in(k0: int, k1: int, data: int) -> tuple:
    """jax.random.fold_in on raw key words: threefry(key, seed-words(data))."""
    return threefry2x32(k0, k1, (data >> 32) & 0xFFFFFFFF, data & 0xFFFFFFFF)


def random_bits(k0: int, k1: int, n: int) -> list:
    """jax.random.bits(key, (n,), uint32) under jax_threefry_partitionable
    (the default): word i is the XOR of the threefry output pair for
    counter (i >> 32, i & 0xffffffff). This is the exact draw stream the
    device engine consumes (engine/rng.py event_bits), reproduced natively."""
    ctr = []
    for i in range(n):
        ctr += ((i >> 32) & 0xFFFFFFFF, i & 0xFFFFFFFF)
    out = threefry2x32_batch(k0, k1, ctr)
    return [out[2 * i] ^ out[2 * i + 1] for i in range(n)]


# ---------------------------------------------------------------- simloop
# The compiled executor core (CPython extension, simloop.c): Future/Sleep/
# Timers/Loop. Unlike the ctypes structures above (whose per-call overhead
# caps their value), this runs the whole per-poll hot sequence in C.

_simloop_mod = None
_simloop_failed = False


def _simloop_cmd() -> list:
    import sysconfig

    # plain C: tentative type definitions + the CPython C API
    return ["gcc", "-O2", "-shared", "-fPIC", "-std=c11",
            "-I" + sysconfig.get_paths()["include"]]


def simloop():
    """The `_simloop` extension module, or None (build failure or
    MADSIM_NO_NATIVE=1). Built lazily like the ctypes core, and loaded
    under this package's own dotted name, so it never shares static state
    with another package's ``_simloop`` in the same interpreter."""
    global _simloop_mod, _simloop_failed
    if _simloop_mod is not None:
        return _simloop_mod
    if _simloop_failed or os.environ.get("MADSIM_NO_NATIVE"):
        return None
    cmd = _simloop_cmd()
    so = _target("_simloop", cmd, _SIMLOOP_SRC)
    if not os.path.exists(so) and not _compile_atomic("_simloop", cmd, _SIMLOOP_SRC, so):
        _simloop_failed = True
        return None
    try:
        import importlib.util

        spec = importlib.util.spec_from_file_location(f"{__name__}._simloop", so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except Exception as e:
        _ERRORS["_simloop"] = f"loading {so}: {e!r}"
        _simloop_failed = True
        return None
    _simloop_mod = mod
    return mod
