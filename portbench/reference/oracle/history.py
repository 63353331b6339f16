# The benchmark's plain reference: a frozen copy of madsim_tpu_torch/oracle/history.py, run on the CPU.
# A change to the program's semantics reaches it only through a change to the benchmark.
"""Operation histories: decode the engine's history planes (the decoder
only; the port's module also records host histories and decodes on the
card).

The engine appends one fixed-width row per dispatched event that the
workload's ``record`` hook elects: five int32 columns ``(client, code,
key, val, opid)`` plus the engine-stamped int64 virtual time. ``code``
packs an op kind and a phase, ``code = op * 2 + phase``, so one client
operation is two rows (invoke, completion) matched by ``(client, opid)``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

# op kinds (the row's code column is ``op * 2 + phase``)
OP_PUT = 0  # key := inp; out echoes inp
OP_GET = 1  # read key; out = value or -1 (absent)
OP_DEL = 2  # delete key (internal ops record invoke == complete)
OP_PRODUCE = 3  # append inp (seq) to log/partition key; out = ack frontier
OP_FETCH = 4  # read from offset inp of partition key; out = records served
OP_ELECT = 5  # node inp won leadership of term key (invoke-only)

OP_NAMES = ("put", "get", "del", "produce", "fetch", "elect")

# phases
PH_INVOKE = 0
PH_OK = 1


def host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Op(NamedTuple):
    """One client-observed operation, paired from its invoke/ok rows."""

    client: int
    op: int  # OP_*
    key: int  # key (KV) or partition (log)
    inp: int  # invoke argument: PUT value / produce seq / fetch offset
    out: int  # completion result (meaningless while ``complete_ns < 0``)
    invoke_ns: int
    complete_ns: int  # -1 = never completed (open op — may have happened)
    opid: int

    @property
    def complete(self) -> bool:
        return self.complete_ns >= 0

    def describe(self) -> str:
        done = f"-> {self.out} @{self.complete_ns}" if self.complete else "-> ?"
        return (
            f"c{self.client} {OP_NAMES[self.op]}(k={self.key}, {self.inp}) "
            f"@{self.invoke_ns} {done}"
        )


class History(NamedTuple):
    """A decoded per-seed operation history."""

    seed: int
    ops: Tuple[Op, ...]  # invoke order (== record-append order)
    overflow: bool  # buffer filled up: ops is a valid strict prefix
    rows: int  # raw rows consumed


def _pair_rows(rec: np.ndarray, t: np.ndarray, n: int) -> Tuple[Op, ...]:
    """Pair invoke/ok rows by (client, opid) into ``Op`` records. An ok
    row with no recorded invoke, or one whose op/key disagree with its
    invoke, is a record-hook contract breach and raises."""
    ops: List[List] = []
    open_ops = {}  # (client, opid) -> index into ops
    for i in range(n):
        client, code, key, val, opid = (int(v) for v in rec[i])
        op, phase = code // 2, code % 2
        when = int(t[i])
        if phase == PH_INVOKE:
            open_ops[(client, opid)] = len(ops)
            ops.append([client, op, key, val, 0, when, -1, opid])
        else:
            j = open_ops.pop((client, opid), None)
            if j is None:
                raise ValueError(
                    f"history row {i} completes op (client={client}, "
                    f"opid={opid}) with no recorded invoke — record-hook "
                    "contract breach"
                )
            if ops[j][1] != op or ops[j][2] != key:
                raise ValueError(
                    f"history row {i} completes (client={client}, "
                    f"opid={opid}) with mismatched op/key "
                    f"({op}/{key} vs {ops[j][1]}/{ops[j][2]})"
                )
            ops[j][4] = val
            ops[j][6] = when
    return tuple(Op(*o) for o in ops)


def decode_rows(rec, t, length, overflow, seed: int = -1) -> History:
    """Decode one seed's raw history arrays (any source) into a History."""
    n = int(length)
    return History(
        seed=int(seed),
        ops=_pair_rows(host(rec), host(t), n),
        overflow=bool(overflow),
        rows=n,
    )
