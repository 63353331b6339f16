"""Real-mode twin — the analogue of the reference's ``std`` tree.

The reference compiles every API to the real library when ``--cfg madsim``
is absent: tokio re-exports, a tag-matching Endpoint over real TCP with
length-delimited frames, and real RPC on top (madsim/src/std/, SURVEY.md
§2.1 "std twin"). This package is the same idea for Python: the simulation
API surface backed by asyncio and real sockets, so workload code written
against madsim_tpu_torch runs unmodified against a real network:

    from madsim_tpu_torch import real as ms       # instead of `import madsim_tpu_torch as ms`
    rt = ms.Runtime()
    rt.block_on(main())

Provided: ``Runtime.block_on``, ``spawn``, ``sleep``/``timeout``/
``interval``/``Instant``, tag-matching ``Endpoint`` (UDP datagrams) and
``TcpEndpoint`` (length-delimited frames over persistent connections, the
reference std transport's shape), the built-in RPC (``call`` /
``add_rpc_handler``) on either, and real-mode twins of ALL FOUR ecosystem
shims — ``real.grpc`` (the same @service classes over framed TCP),
``real.etcd``, ``real.kafka``, ``real.s3`` (the unchanged client APIs
against the framework's own state machines on real sockets) — plus
``real.fs`` (the sim fs API over actual files, the std/fs.rs analogue)
and ``real.signal`` (``ctrl_c`` over a real SIGINT). Frames use
the restricted binary codec (real/codec.py) — never pickle, so a hostile
peer cannot execute code.
Randomness is real randomness; there is no determinism in real mode
(matching the reference, where buggify is a no-op and seeds don't exist,
std/buggify.rs:6-30).
"""

from .runtime import Runtime, spawn
from .time import Instant, interval, now_instant, sleep, timeout
from .net import Endpoint, TcpEndpoint
from . import codec
from . import stream
from . import grpc
from . import etcd
from . import fs
from . import kafka
from . import s3
from . import signal

__all__ = [
    "Endpoint",
    "TcpEndpoint",
    "codec",
    "etcd",
    "fs",
    "grpc",
    "kafka",
    "s3",
    "signal",
    "stream",
    "Instant",
    "Runtime",
    "interval",
    "now_instant",
    "sleep",
    "spawn",
    "timeout",
]
