"""Operation histories: decode the engine's history planes, record host
histories (the port's copy of ``madsim_tpu/oracle/history.py``).

The engine appends one fixed-width row per dispatched event that the
workload's ``record`` hook elects: five int32 columns ``(client, code,
key, val, opid)`` plus the engine-stamped int64 virtual time. ``code``
packs an op kind and a phase, ``code = op * 2 + phase``, so one client
operation is two rows (invoke, completion) matched by ``(client, opid)``.

The decoders are numpy host code, as in the reference. A plane that lives
on the card is read through ``.cpu().numpy()``; this module never imports
``torch`` at module level (``canon_sweep`` imports it when called), so the
checker's pool workers, which import it, stay numpy-only.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

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


def code_of(op: int, phase: int) -> int:
    """The row code the record hooks write: ``op * 2 + phase``."""
    return op * 2 + phase


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


def decode_seed(final, lane: Optional[int] = None) -> History:
    """Decode the history planes of a finished ``EngineState``:
    unbatched (``run_traced``'s final) when ``lane`` is None, else lane
    ``lane`` of a batched sweep state."""
    if lane is None:
        return decode_rows(
            final.hist_rec, final.hist_t, host(final.hist_len),
            host(final.hist_overflow), seed=int(host(final.seed)),
        )
    return decode_lanes(final, [lane])[0]


def decode_lanes(final, lanes) -> List[History]:
    """Decode selected lanes of a batched sweep state, in the given order.

    The device-to-host copy is sized to the selection, as the reference
    sizes it: an empty selection copies nothing, and one of at most a
    quarter of the lanes is gathered on the device first, so a chunk
    with a few suspects moves kilobytes, not the whole plane."""
    lanes = [int(lane) for lane in lanes]
    if not lanes:
        return []
    n_total = int(final.seed.shape[0])
    if len(lanes) * 4 <= n_total:
        idx = np.asarray(lanes, dtype=np.int64)
        planes = (
            final.hist_rec[idx], final.hist_t[idx],
            final.hist_len[idx], final.hist_overflow[idx],
            final.seed[idx],
        )
        sel = range(len(lanes))
    else:
        planes = (
            final.hist_rec, final.hist_t, final.hist_len,
            final.hist_overflow, final.seed,
        )
        sel = lanes
    rec, t, length, ov, seeds = (host(p) for p in planes)
    return [
        decode_rows(rec[i], t[i], length[i], ov[i], seed=int(seeds[i]))
        for i in sel
    ]


def decode_sweep(final) -> List[History]:
    """Decode every lane of a batched sweep state (one copy off the
    device, then a host loop)."""
    return decode_lanes(final, range(int(final.seed.shape[0])))


def history_bytes(hist: History) -> bytes:
    """Canonical byte encoding of a decoded history — the determinism
    gate's encoding (no wall times, no paths, no float repr)."""
    lines = [f"seed={hist.seed} rows={hist.rows} overflow={int(hist.overflow)}"]
    lines += [
        f"c={o.client} op={OP_NAMES[o.op]} key={o.key} in={o.inp} "
        f"out={o.out if o.complete else '?'} "
        f"t=[{o.invoke_ns},{o.complete_ns}] id={o.opid}"
        for o in hist.ops
    ]
    return ("\n".join(lines) + "\n").encode()


_CANON_MAGIC = b"MTHC1\n"  # canonical-row format tag
_CANON_COLS = 8  # (client, op, key, inp, out, rank_inv, rank_comp, opid)


def canonical_bytes_from_rows(rows, n_ops, raw_rows, overflow) -> bytes:
    """The canonical byte encoding from fixed-width ``int32[*, 8]`` rows in
    invoke order (``client, op, key, inp, out-or-0-while-open, invoke
    rank, complete rank or -1, opid``): a magic tag, an ``(raw_rows,
    overflow)`` int32 header and the first ``n_ops`` rows, little-endian.
    The host path and ``canon_sweep`` both funnel through here."""
    n = int(n_ops)
    head = np.asarray([int(raw_rows), int(bool(overflow))], dtype="<i4")
    body = np.ascontiguousarray(np.asarray(rows, dtype=np.int32)[:n], dtype="<i4")
    return _CANON_MAGIC + head.tobytes() + body.tobytes()


def canonical_rows(hist: History) -> np.ndarray:
    """Host-side canonical rows (``int32[n_ops, 8]``): each op's fields
    with its times replaced by their dense rank over the history's
    distinct valid times (open completions stay -1, an open op's ``out``
    is 0)."""
    ts = sorted(
        {t for o in hist.ops for t in (o.invoke_ns, o.complete_ns) if t >= 0}
    )
    rank = {t: i for i, t in enumerate(ts)}
    return np.asarray(
        [
            (
                o.client, o.op, o.key, o.inp,
                o.out if o.complete else 0,
                rank[o.invoke_ns],
                rank[o.complete_ns] if o.complete else -1,
                o.opid,
            )
            for o in hist.ops
        ],
        dtype=np.int32,
    ).reshape(len(hist.ops), _CANON_COLS)


def history_canonical_bytes(hist: History) -> bytes:
    """Seed-free, time-rank canonical encoding — the dedup key of the
    checked sweep's WGL checking. Two histories that differ only in seed
    and in absolute times (not in the order of their times) get equal
    bytes; the checker reads times only through comparisons, so one
    verdict holds for the class."""
    return canonical_bytes_from_rows(
        canonical_rows(hist), len(hist.ops), hist.rows, hist.overflow
    )


def history_from_canon(rows, n_ops, overflow, raw_rows, seed: int = -1) -> History:
    """A checkable ``History`` from canonical rows, each op's dense time
    ranks standing in for its times (an order-isomorphism, so the
    checker's verdict is the host-decoded history's)."""
    n = int(n_ops)
    r = np.asarray(rows)
    ops = tuple(
        Op(
            client=int(r[i, 0]), op=int(r[i, 1]), key=int(r[i, 2]),
            inp=int(r[i, 3]), out=int(r[i, 4]),
            invoke_ns=int(r[i, 5]), complete_ns=int(r[i, 6]),
            opid=int(r[i, 7]),
        )
        for i in range(n)
    )
    return History(seed=int(seed), ops=ops, overflow=bool(overflow), rows=int(raw_rows))


# lanes per canon_sweep block: bounds the [block, H, H] pairwise masks
CANON_BLOCK = 1024


def _canon_block(rec, t, n):
    """Canonical rows of a block of lanes (the reference's vmapped
    ``_canon_kernel`` with the lane axis written out): ``rec int32[B, H,
    5]``, ``t int64[B, H]``, ``n [B]`` -> ``(canon int32[B, H, 8], n_ops
    int64[B], breach bool[B])``."""
    import torch

    b, h = t.shape
    dev = t.device
    idx = torch.arange(h, dtype=torch.int32, device=dev)
    valid = idx[None, :] < n.to(torch.int32)[:, None]
    client, code, key, val, opid = (rec[:, :, c] for c in range(5))
    op, ph = code // 2, code % 2
    inv = valid & (ph == PH_INVOKE)
    okm = valid & (ph == PH_OK)
    # pairing: ok row k matches the latest invoke row i of the same
    # (client, opid) with prev_ok(k) < i < k, where prev_ok(k) is k's
    # latest earlier ok sibling — _pair_rows' dict semantics. No match,
    # or an op/key mismatch, is a breach the host decoder raises on
    same = (client[:, :, None] == client[:, None, :]) & (opid[:, :, None] == opid[:, None, :])
    same_earlier = same & (idx[None, None, :] < idx[None, :, None])
    del same
    jdx = idx[None, None, :]
    prev_ok = torch.where(same_earlier & okm[:, None, :], jdx, -1).amax(dim=2)
    cand = same_earlier & inv[:, None, :] & (jdx > prev_ok[:, :, None])
    del same_earlier
    match = torch.where(cand, jdx, -1).amax(dim=2)
    del cand
    m = match.clamp(0, h - 1).to(torch.int64)
    mism = (torch.gather(op, 1, m) != op) | (torch.gather(key, 1, m) != key)
    breach = (okm & ((match < 0) | mism)).any(dim=1)
    # dense time rank: the number of distinct valid times strictly below
    # a row's own (only the first row of a tie group counts as distinct)
    earlier = idx[None, :] < idx[:, None]
    tie = (t[:, None, :] == t[:, :, None]) & earlier[None] & valid[:, None, :]
    first = valid & ~tie.any(dim=2)
    del tie
    rank = (first[:, None, :] & (t[:, None, :] < t[:, :, None])).sum(dim=2).to(torch.int32)
    # assembly: invoke k is op number slot[k]; invoke rows scatter whole,
    # then (out, rank_comp) are patched at the matched slots; masked rows
    # go to the dump row h, which is cut off
    slot = torch.cumsum(inv.to(torch.int64), dim=1) - 1
    n_ops = inv.to(torch.int64).sum(dim=1)
    inv_rows = torch.stack(
        [client, op, key, val, torch.zeros_like(val), rank,
         torch.full_like(val, -1), opid],
        dim=2,
    ).to(torch.int32)
    lane = torch.arange(b, device=dev)[:, None].expand(b, h)
    canon = torch.zeros((b, h + 1, _CANON_COLS), dtype=torch.int32, device=dev)
    canon[lane, torch.where(inv, slot, h)] = inv_rows
    ok_tgt = torch.where(okm & (match >= 0), torch.gather(slot, 1, m), h)
    canon[lane, ok_tgt, 4] = val.to(torch.int32)
    canon[lane, ok_tgt, 6] = rank
    return canon[:, :h], n_ops, breach


def canon_sweep(final, block: int = CANON_BLOCK):
    """Canonical decode of every lane of a finished sweep state on its
    device: ``(canon int32[S, H, 8], n_ops int64[S], breach bool[S])``,
    the reference's outputs and dtypes.

    ``canon[s, :n_ops[s]]`` are lane ``s``'s canonical rows, equal to
    ``canonical_rows(decode_seed(final, s))``; ``breach[s]`` marks an
    orphan ok row or an op/key mismatch, a lane the caller routes
    through the host decoder for its diagnostic. Lanes are processed in
    ``block``-lane batches, each cut to its longest history (rows past a
    lane's length take part in nothing, so the cut changes no value)."""
    import torch

    rec, t, length = final.hist_rec, final.hist_t, final.hist_len
    s, h = t.shape
    dev = t.device
    canon = torch.zeros((s, h, _CANON_COLS), dtype=torch.int32, device=dev)
    n_ops = torch.zeros((s,), dtype=torch.int64, device=dev)
    breach = torch.zeros((s,), dtype=torch.bool, device=dev)
    if s == 0 or h == 0:
        return canon, n_ops, breach
    widths = _block_widths(length, h, block)
    for lo, w in zip(range(0, s, block), widths):
        hi = min(s, lo + block)
        c, no, br = _canon_block(rec[lo:hi, :w], t[lo:hi, :w], length[lo:hi])
        canon[lo:hi, :w] = c
        n_ops[lo:hi] = no
        breach[lo:hi] = br
    return canon, n_ops, breach


def _block_widths(length, h: int, block: int) -> List[int]:
    """Per ``block``-lane batch, the rows that can hold a valid record:
    its longest history, within ``[1, h]`` (one copy off the device)."""
    import torch

    s = int(length.shape[0])
    pad = -s % block
    n = torch.cat([length.to(torch.int64), length.new_zeros(pad).to(torch.int64)])
    top = n.reshape(-1, block).amax(dim=1).clamp(1, h)
    return [int(v) for v in top.tolist()]


class HostRecorder:
    """Thin client-shim recording host-tier operation histories.

    The host tier runs arbitrary async Python under the same virtual
    clock; wrapping each client call in ``invoke``/``complete`` yields
    the same ``History`` structure the device decoder produces, so one
    checker serves both tiers::

        rec = HostRecorder()
        opid = rec.invoke(client=0, op=OP_PUT, key=3, inp=42)
        resp = await kv.put(b"k3", b"42")
        rec.complete(client=0, opid=opid, out=42)
        check_history(rec.history(), KVSpec())

    Times default to the running simulation's virtual clock
    (``madsim_tpu_torch.time``); pass ``clock`` (a ``() -> int`` of
    nanoseconds) to record outside a sim context. NOTE: two engines
    cannot share one RNG stream, so a host history for a ``(spec,
    seed)`` is *not* byte-comparable to the device history — byte
    identity is the contract between the device sweep and its CPU
    ``run_traced`` replay; host histories share only the format and the
    checker (docs/oracle.md).
    """

    def __init__(self, clock: Optional[Callable[[], int]] = None):
        if clock is None:
            def clock() -> int:
                from ..context import current_handle

                return int(current_handle().time.now_ns)

        self._clock = clock
        self._rows: List[Tuple[int, int, int, int, int, int]] = []
        self._next_opid = {}
        self._open = {}  # (client, opid) -> (invoke code, key)

    def invoke(self, client: int, op: int, key: int, inp: int) -> int:
        """Record an op's invocation; returns the opid to complete with."""
        opid = self._next_opid.get(client, 0)
        self._next_opid[client] = opid + 1
        code = code_of(op, PH_INVOKE)
        self._open[(client, opid)] = (code, key)
        self._rows.append((client, code, key, inp, opid, self._clock()))
        return opid

    def complete(self, client: int, opid: int, out: int) -> None:
        """Record an op's completion; an unknown or already-completed op
        raises here, at the offending call."""
        entry = self._open.pop((client, opid), None)
        if entry is None:
            raise ValueError(
                f"complete() for unknown or already-completed "
                f"(client={client}, opid={opid})"
            )
        code, key = entry
        self._rows.append((client, code + 1, key, out, opid, self._clock()))

    def history(self, seed: int = -1) -> History:
        rec = np.asarray([r[:5] for r in self._rows], dtype=np.int32).reshape(
            len(self._rows), 5
        )
        t = np.asarray([r[5] for r in self._rows], dtype=np.int64)
        return decode_rows(rec, t, len(self._rows), False, seed=seed)
