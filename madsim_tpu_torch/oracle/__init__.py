"""History oracle: linearizability checking of recorded operation
histories (counterpart of ``madsim_tpu.oracle``).

- ``history`` decodes the engine's per-seed history planes into paired
  operations, and records host histories in the same format;
- ``specs`` holds the sequential specs (KV register, ordered log, S3
  object register, election safety);
- ``check`` is the WGL search with memoized states, per-key partitions
  and first-bad-prefix location, over a process pool;
- ``screen`` is the conservative first pass on the device, and
  ``checked_sweep`` the pipelined sweep + screen + check driver. It is
  the one module here that imports ``torch`` and is imported on demand,
  so these exports leave the checker's pool workers numpy-only.
"""

from .check import (
    CheckResult,
    check_histories,
    check_history,
    first_bad_prefix,
    violating_seeds,
)
from .history import (
    OP_NAMES,
    History,
    HostRecorder,
    Op,
    decode_lanes,
    decode_seed,
    decode_sweep,
    history_bytes,
)
from .specs import ElectionSpec, KVSpec, LogSpec, S3Spec

__all__ = [
    "CheckResult",
    "check_histories",
    "check_history",
    "first_bad_prefix",
    "violating_seeds",
    "OP_NAMES",
    "History",
    "HostRecorder",
    "Op",
    "decode_lanes",
    "decode_seed",
    "decode_sweep",
    "history_bytes",
    "ElectionSpec",
    "KVSpec",
    "LogSpec",
    "S3Spec",
]
