"""History screening on the device and the checked sweep (counterpart of
``madsim_tpu/oracle/screen.py``).

The WGL checker (``oracle/check.py``) is per-seed host Python. The screen
is its conservative first pass: per-seed quick checks written as masked
reductions over a finished chunk's history planes, one bool per seed —
*suspect* or *provably clean*. Decoding and the WGL search then run only
on the suspect lanes. The suspect set is a superset of the seeds the
checker rejects, so skipping the clean lanes hides no violation:

- ``kv`` (etcd's register spec): exact within a per-key contention window
  (``kv_window_suspect``; see its docstring), suspect when some key's
  concurrent-op depth exceeds ``KV_WINDOW``; duplicate written values,
  re-invoked opids and DEL rows flag the seed wholesale;
- ``log`` (kafka's ordered log): a fetch serving past every produce that
  could precede it, or breaking per-consumer offset contiguity;
- ``election`` (raft): two ELECT rows naming different winners for one
  term, exactly ``specs.ElectionSpec.structural``.

Unknown op kinds and ok rows with no recorded invoke flag the seed. An
overflowed history screens its valid prefix, the prefix the checker sees.

Where the reference vmaps a per-seed function over ``[H, H]`` masks, each
screen here is one function over a lane batch: ``rec int32[B, H, 5]``,
``t int64[B, H]``, ``n [B]`` -> ``bool[B]``, its pairwise masks
``[B, H, H]`` (row ``i`` on axis 1, row ``j`` on axis 2). ``screen_sweep``
runs them in ``block``-lane batches, each cut to its longest history:
rows past a lane's length take part in no reduction, so the cut changes
no bit.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .history import (
    OP_ELECT,
    OP_FETCH,
    OP_GET,
    OP_PRODUCE,
    OP_PUT,
    PH_INVOKE,
    PH_OK,
    _block_widths,
    host,
)
from .. import resolve_device
from .specs import ABSENT

# int64 sentinels: "no such time" below/above any virtual timestamp
_T_NEG = -(1 << 62)
_T_INF = 1 << 62
_I32_MIN = -(1 << 31)

# contention budget of the exact kv screen: a key whose concurrent-op
# depth ever exceeds this many ops falls back to "suspect"
KV_WINDOW = 32


def _i(x: torch.Tensor) -> torch.Tensor:
    """A per-row ``[B, H]`` value as row ``i`` of a pairwise mask."""
    return x[:, :, None]


def _j(x: torch.Tensor) -> torch.Tensor:
    """A per-row ``[B, H]`` value as row ``j`` of a pairwise mask."""
    return x[:, None, :]


def _any2(m: torch.Tensor) -> torch.Tensor:
    """Per lane: any element of a ``[B, H, H]`` mask."""
    return m.flatten(1).any(dim=1)


def _add32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 addition that wraps as the reference's int32 arithmetic does."""
    s = a.to(torch.int64) + b.to(torch.int64)
    return ((s + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def _cols(rec, t, n):
    """Split a lane batch's raw rows into masked columns."""
    h = t.shape[1]
    idx = torch.arange(h, dtype=torch.int32, device=t.device)
    valid = idx[None, :] < n.to(torch.int32)[:, None]
    client, code, key, val, opid = (rec[:, :, c] for c in range(5))
    op, ph = code // 2, code % 2
    return idx[None, :], valid, client, op, ph, key, val, opid, t


def _invoke_join(idx, valid, client, op, ph, opid, t):
    """For every ok row, the time of its invoke row, and the pair mask.
    An ok row pairs with the latest earlier matching invoke; one with no
    match gets ``_T_NEG`` (callers flag it)."""
    pair = (
        _i(valid & (ph == PH_OK))
        & _j(valid & (ph == PH_INVOKE))
        & (_i(client) == _j(client))
        & (_i(op) == _j(op))
        & (_i(opid) == _j(opid))
        & (_j(idx) < _i(idx))
    )
    inv_t = torch.where(pair, _j(t), _T_NEG).amax(dim=2)
    return inv_t, pair


def kv_suspect(rec, t, n) -> torch.Tensor:
    """Suspect bits under the KV register spec — the original
    necessary-condition screen, kept beside ``kv_window_suspect`` (the
    registered ``kv`` screen) for comparison."""
    idx, valid, client, op, ph, key, val, opid, t = _cols(rec, t, n)
    inv_t, _ = _invoke_join(idx, valid, client, op, ph, opid, t)

    put_inv = valid & (op == OP_PUT) & (ph == PH_INVOKE)
    put_ok = valid & (op == OP_PUT) & (ph == PH_OK)
    get_ok = valid & (op == OP_GET) & (ph == PH_OK)
    obs_ok = put_ok | get_ok

    unscreenable = (valid & ~((op == OP_PUT) | (op == OP_GET))).any(dim=1)
    orphan = ((valid & (ph == PH_OK)) & (inv_t == _T_NEG)).any(dim=1)

    same_key = _i(key) == _j(key)
    same_val = _i(val) == _j(val)
    dup = _any2(_i(put_inv) & _j(put_inv) & same_key & same_val & (_i(idx) < _j(idx)))

    # commit time of the unique PUT that wrote (key_i, out_i); an open
    # write commits "never"
    wrote = _j(put_ok) & same_key & same_val
    cmp_v = torch.where(
        wrote.any(dim=2), torch.where(wrote, _j(t), _T_NEG).amax(dim=2), _T_INF
    )
    del wrote
    ti, tc = inv_t, t

    bad_absent = (val == ABSENT) & (_j(put_ok) & same_key & (_j(t) < _i(ti))).any(dim=2)
    no_writer = (val != ABSENT) & ~(
        _j(put_inv) & same_key & same_val & (_j(t) <= _i(tc))
    ).any(dim=2)
    fresher = (val != ABSENT) & (
        _j(obs_ok) & same_key & ~same_val & (_j(t) < _i(ti)) & (_j(inv_t) > _i(cmp_v))
    ).any(dim=2)
    bad = get_ok & (bad_absent | no_writer | fresher)
    return bad.any(dim=1) | dup | unscreenable | orphan


def kv_window_suspect(rec, t, n, window: int = KV_WINDOW) -> torch.Tensor:
    """Suspect bits under the KV register spec — exact within a per-key
    contention window.

    For a unique-value register history, group ops into value clusters
    ``C_v`` = the PUT writing v and the completed GETs reading v, with
    ``m_v`` the earliest completion in the cluster and ``s_v`` the latest
    invoke. The history is linearizable iff (A) every completed
    non-ABSENT read's value has a PUT invoked no later than the read
    completes; (B) no completed non-ABSENT observation of a key completes
    before an ABSENT read of it invokes; (C) no two clusters on a key
    2-cycle (``m_u < s_v`` and ``m_v < s_u``). A lane is suspect when one
    fails, or when some key's concurrent-op depth exceeds ``window``, or
    on the wholesale flags (duplicate values, re-invoked opids, rows of
    another kind, orphan ok rows)."""
    idx, valid, client, op, ph, key, val, opid, t = _cols(rec, t, n)
    inv_t, pair = _invoke_join(idx, valid, client, op, ph, opid, t)

    put_inv = valid & (op == OP_PUT) & (ph == PH_INVOKE)
    put_ok = valid & (op == OP_PUT) & (ph == PH_OK)
    get_ok = valid & (op == OP_GET) & (ph == PH_OK)
    obs_ok = put_ok | get_ok
    ok_row = valid & (ph == PH_OK)
    inv_row = valid & (ph == PH_INVOKE)

    # wholesale flags: rows the value-identity argument cannot cover
    unscreenable = (valid & ~((op == OP_PUT) | (op == OP_GET))).any(dim=1)
    orphan = (ok_row & (inv_t == _T_NEG)).any(dim=1)
    reinvoke = _any2(
        _i(inv_row) & _j(inv_row) & (_i(client) == _j(client))
        & (_i(opid) == _j(opid)) & (_i(idx) < _j(idx))
    )

    same_key = _i(key) == _j(key)
    same_val = _i(val) == _j(val)
    dup = _any2(_i(put_inv) & _j(put_inv) & same_key & same_val & (_i(idx) < _j(idx)))

    # an invoke row with a later matching ok row completed
    claimed = pair.any(dim=1)
    del pair
    open_inv = inv_row & ~claimed
    open_put = put_inv & ~claimed

    # (A) — also catches a read completing before its write invokes
    no_writer = (val != ABSENT) & ~(
        _j(put_inv) & same_key & same_val & (_j(t) <= _i(t))
    ).any(dim=2)
    bad_a = get_ok & no_writer

    # (B)
    bad_b = get_ok & (val == ABSENT) & (
        _j(obs_ok) & same_key & _j(val != ABSENT) & (_j(t) < _i(inv_t))
    ).any(dim=2)

    # (C) — m per cluster (shared by its member rows), s per row
    rep = (obs_ok | open_put) & (val != ABSENT)
    memb = _j(obs_ok) & same_key & same_val
    m = torch.where(memb, _j(t), _T_INF).amin(dim=2)
    del memb
    start = torch.where(obs_ok, inv_t, t)
    cyc = _any2(
        _i(rep) & _j(rep) & same_key & ~same_val
        & (_i(m) < _j(start)) & (_j(m) < _i(start))
    )

    # window budget: per-key concurrent-op depth at each op's invoke
    o_mask = ok_row | open_inv
    o_start = torch.where(ok_row, inv_t, t)
    o_end = torch.where(ok_row, t, _T_INF)
    depth = (
        _i(o_mask) & _j(o_mask) & same_key
        & (_j(o_start) <= _i(o_start)) & (_i(o_start) <= _j(o_end))
    ).sum(dim=2)
    over_budget = (o_mask & (depth > window)).any(dim=1)

    return (
        (bad_a | bad_b).any(dim=1) | cyc | over_budget | dup | reinvoke
        | unscreenable | orphan
    )


def log_suspect(rec, t, n) -> torch.Tensor:
    """Suspect bits under the ordered-log spec (kafka)."""
    idx, valid, client, op, ph, key, val, opid, t = _cols(rec, t, n)
    inv_t, pair = _invoke_join(idx, valid, client, op, ph, opid, t)

    prod_inv = valid & (op == OP_PRODUCE) & (ph == PH_INVOKE)
    fetch_ok = valid & (op == OP_FETCH) & (ph == PH_OK)

    unscreenable = (valid & ~((op == OP_PRODUCE) | (op == OP_FETCH))).any(dim=1)
    orphan = (fetch_ok & (inv_t == _T_NEG)).any(dim=1)

    same_key = _i(key) == _j(key)

    # each fetch's offset rides on its (latest matching) invoke row
    jlast = torch.where(pair, _j(idx), -1).amax(dim=2)
    onehot = pair & (_j(idx) == _i(jlast))
    del pair
    off = torch.where(onehot, _j(val), _I32_MIN).amax(dim=2)
    del onehot
    served = val

    # overread: serving past every produce invoked before the completion
    navail = (_j(prod_inv) & same_key & (_j(t) <= _i(t))).sum(dim=2)
    overread = fetch_ok & (_add32(off, served) > navail)

    # per-consumer offset contiguity in completion (= row) order
    prevm = (
        _i(fetch_ok) & _j(fetch_ok) & same_key
        & (_i(client) == _j(client)) & (_j(idx) < _i(idx))
    )
    jprev = torch.where(prevm, _j(idx), -1).amax(dim=2)
    sel_prev = prevm & (_j(idx) == _i(jprev))
    del prevm
    prev_off = torch.where(sel_prev, _j(off), _I32_MIN).amax(dim=2)
    prev_served = torch.where(sel_prev, _j(val), _I32_MIN).amax(dim=2)
    expect = torch.where(jprev >= 0, _add32(prev_off, prev_served), 0)
    gap = fetch_ok & (off != expect)

    return (overread | gap).any(dim=1) | unscreenable | orphan


def election_suspect(rec, t, n) -> torch.Tensor:
    """Suspect bits under the election spec (raft) — precise: two ELECT
    rows naming different winners for one term."""
    idx, valid, client, op, ph, key, val, opid, t = _cols(rec, t, n)
    elect = valid & (op == OP_ELECT) & (ph == PH_INVOKE)
    unscreenable = (valid & ~(op == OP_ELECT)).any(dim=1)
    split = _any2(
        _i(elect) & _j(elect) & (_i(key) == _j(key)) & (_i(val) != _j(val))
    )
    return split | unscreenable


_SCREENS = {
    "kv": kv_window_suspect,
    "log": log_suspect,
    "election": election_suspect,
}


def screen_for(spec) -> Optional[Callable]:
    """The batched screen for a sequential spec, by its ``name``, or None
    when no screen exists (callers then check every seed)."""
    return _SCREENS.get(getattr(spec, "name", None))


def screen_history(rec, t, n, spec, device=None) -> bool:
    """Screen ONE seed's raw history rows (tests and replay tooling).

    Rows given as a tensor are screened on their own device; numpy rows
    on ``device`` (None means CUDA)."""
    fn = screen_for(spec)
    if fn is None:
        raise ValueError(f"no device screen for spec {spec.name!r}")
    if device is None and isinstance(rec, torch.Tensor):
        dev = rec.device
    else:
        dev = resolve_device(device)
    rec = torch.as_tensor(rec, device=dev).to(torch.int32)[None]
    t = torch.as_tensor(t, device=dev).to(torch.int64)[None]
    return bool(fn(rec, t, torch.tensor([int(n)], dtype=torch.int32, device=dev))[0])


def screen_sweep(final, spec, block: int = 1024, mesh=None) -> torch.Tensor:
    """Suspect mask (bool[S], on the state's device) of a finished
    batched sweep, screened in ``block``-lane batches (the bound on the
    ``[block, H, H]`` masks). The mask is not copied to the host: the
    pipelined driver reads it in the next chunk's host phase.

    With ``mesh`` (a ``parallel.SeedMesh``; every rank calls), ``final``
    is the whole batch as the sharded drivers return it: each rank
    screens its own shard of the lanes, and the ranks' bits are gathered
    into the whole mask, equal to the unsharded screen's."""
    fn = screen_for(spec)
    if fn is None:
        raise ValueError(
            f"no device screen for spec {getattr(spec, 'name', spec)!r}; "
            "pass screen=False (check every lane) instead"
        )
    rec, t, length = final.hist_rec, final.hist_t, final.hist_len
    if mesh is not None:
        lo, m = mesh.shard(int(t.shape[0]))
        rec, t, length = rec[lo:lo + m], t[lo:lo + m], length[lo:lo + m]
    s, h = t.shape
    if h == 0 or s == 0:
        # no recording plane: nothing to screen, nothing to check
        mask = torch.zeros((s,), dtype=torch.bool, device=t.device)
    else:
        widths = _block_widths(length, h, block)
        mask = torch.cat([
            fn(rec[lo:lo + block, :w], t[lo:lo + block, :w], length[lo:lo + block])
            for lo, w in zip(range(0, s, block), widths)
        ])
    if mesh is None:
        return mask
    from ..parallel.mesh import gather_rows

    return gather_rows(mesh, mask)


class _HostWork:
    """The host phase of a screened checked sweep: decode the suspect
    lanes, dedup them on canonical bytes, check one representative per
    class with the WGL checker over a process pool, and fold the
    verdicts into per-chunk report dicts.

    Two protocols over one pipeline: the sync callable
    ``host_work(final, lo=..., ...)`` (submit + drain, returning the
    chunk's report), and the incremental ``submit`` / ``poll(seconds)`` /
    ``drain``, which drivers that see ``incremental = True`` use to slice
    the checking under a budget; reports come back in submission order.

    ``device_decode=True`` takes the canonical rows from ``canon_sweep``
    on the state's device instead of decoding each row on the host: the
    host gathers the suspect lanes' rows, hashes them and builds a
    ``History`` only for each class's representative. Both routes give
    equal canonical bytes and so equal reports; a lane whose rows breach
    the record-hook contract goes to the host decoder, which raises.

    Every report dict is a pure function of its chunk's history planes:
    worker count, poll cadence and decode route change wall time only.
    ``telemetry`` (duck-typed: ``count``/``gauge``/``observe``) records
    out of band, never a report byte."""

    incremental = True

    def __init__(self, spec, max_states, workers, max_recorded, telemetry, device_decode):
        from collections import deque

        self._spec = spec
        self._max_states = max_states
        self._workers = workers
        self._max_recorded = max_recorded
        self._telemetry = telemetry
        self._device_decode = device_decode
        # WGL slice granularity: scheduling only, never a report byte
        self._step = max(8, 4 * max(1, workers))
        self._q: deque = deque()

    def __call__(self, final, *, lo, n, seeds, suspect, summary):
        self.submit(final, lo=lo, n=n, seeds=seeds, suspect=suspect, summary=summary)
        return self.drain()[-1][1]

    def submit(self, final, *, lo, n, seeds, suspect, summary) -> None:
        """Decode + dedup one chunk now; queue its WGL work."""
        import hashlib
        import time as _time

        from .history import (
            canon_sweep,
            canonical_bytes_from_rows,
            decode_lanes,
            history_canonical_bytes,
            history_from_canon,
        )

        del seeds, summary
        t0 = _time.perf_counter()
        n = int(n)
        if suspect is None:
            lanes = np.arange(n)
        else:
            lanes = np.nonzero(host(suspect)[:n])[0]
        rep: dict = {}  # canonical hash -> index into reps
        reps: list = []
        keys: list = []
        lane_seeds: list = []
        if self._device_decode and int(final.hist_rec.shape[1]) > 0:
            canon, n_ops, breach = canon_sweep(final)
            total = int(final.seed.shape[0])
            if lanes.size and lanes.size * 4 <= total:
                # sparse selection: gather on the device first
                planes = (
                    canon[lanes], n_ops[lanes], breach[lanes],
                    final.hist_len[lanes], final.hist_overflow[lanes],
                    final.seed[lanes],
                )
                pos = np.arange(lanes.size)
            else:
                planes = (
                    canon, n_ops, breach, final.hist_len,
                    final.hist_overflow, final.seed,
                )
                pos = lanes
            rows_c, nops_h, br_h, len_h, ov_h, seed_h = (host(p) for p in planes)
            for j, p in enumerate(pos):
                if br_h[p]:
                    decode_lanes(final, [int(lanes[j])])
                    raise RuntimeError(
                        f"device canonical decode flagged lane {int(lanes[j])} "
                        "but the host decoder accepted it"
                    )
                keys.append(
                    hashlib.sha256(
                        canonical_bytes_from_rows(rows_c[p], nops_h[p], len_h[p], ov_h[p])
                    ).digest()
                )
                lane_seeds.append(int(seed_h[p]))
                if keys[-1] not in rep:
                    rep[keys[-1]] = len(reps)
                    reps.append(
                        history_from_canon(
                            rows_c[p], nops_h[p], ov_h[p], len_h[p], seed=lane_seeds[-1]
                        )
                    )
        else:
            for h in decode_lanes(final, lanes):
                k = hashlib.sha256(history_canonical_bytes(h)).digest()
                keys.append(k)
                lane_seeds.append(int(h.seed))
                if k not in rep:
                    rep[k] = len(reps)
                    reps.append(h)
        if self._telemetry is not None:
            self._telemetry.count("oracle_screened_total", n)
            self._telemetry.count("oracle_suspects_total", int(lanes.size))
            self._telemetry.count("oracle_unique_total", len(reps))
            self._telemetry.gauge(
                "oracle_suspect_rate", lanes.size / max(n, 1),
                help="suspect lanes / screened lanes, last chunk",
            )
            if lanes.size:
                self._telemetry.gauge(
                    "oracle_dedup_ratio", len(reps) / lanes.size,
                    help="unique canonical histories / suspects "
                    "(lower = more dedup wins)",
                )
        self._q.append(
            {
                "lo": lo, "n": n, "suspects": int(lanes.size),
                "keys": keys, "seeds": lane_seeds, "rep": rep,
                "reps": reps, "results": [], "next": 0,
                "host_s": _time.perf_counter() - t0,
            }
        )

    def poll(self, seconds: Optional[float] = None) -> list:
        """Run queued WGL work for roughly ``seconds`` (None = until
        empty); returns ``(lo, report_dict)`` for every chunk that
        finished, in submission order. Always makes progress when work is
        pending; the budget shapes scheduling only."""
        import time as _time

        from .check import check_histories

        out = []
        deadline = None if seconds is None else _time.perf_counter() + seconds
        sliced = False
        while self._q:
            e = self._q[0]
            reps = e["reps"]
            while e["next"] < len(reps):
                if deadline is not None and sliced and _time.perf_counter() >= deadline:
                    return out
                j = min(len(reps), e["next"] + self._step)
                tc = _time.perf_counter()
                e["results"].extend(
                    check_histories(
                        reps[e["next"]:j], self._spec,
                        max_states=self._max_states, workers=self._workers,
                    )
                )
                e["host_s"] += _time.perf_counter() - tc
                e["next"] = j
                sliced = True
            out.append((e["lo"], self._finalize(e)))
            self._q.popleft()
        return out

    def drain(self) -> list:
        """Finish ALL queued work; ``(lo, report_dict)`` in submission order."""
        return self.poll(None)

    def _finalize(self, e: dict) -> dict:
        rep_results = e["results"]
        results = [rep_results[e["rep"][k]] for k in e["keys"]]
        bad = [s for s, r in zip(e["seeds"], results) if not r.ok]
        undecided = sum(1 for r in results if not r.decided)
        # distinct WGL searches that hit max_states
        exhausted = sum(1 for r in rep_results if not r.decided)
        reps, workers = e["reps"], self._workers
        if self._telemetry is not None:
            if bad:
                self._telemetry.count("oracle_violations_total", len(bad))
            if exhausted:
                self._telemetry.count(
                    "oracle_budget_exceeded_total", exhausted,
                    help="WGL searches that exhausted max_states "
                    "(verdict undecided, fails clean)",
                )
            if workers > 0 and reps:
                waves = -(-len(reps) // workers)
                self._telemetry.gauge(
                    "oracle_pool_utilization", len(reps) / (workers * waves),
                    help="checked histories / (workers x waves), last chunk",
                )
            self._telemetry.observe(
                "oracle_check_seconds", e["host_s"],
                help="decode+dedup+WGL check per chunk",
            )
        return {
            "hist_screened": e["n"],
            "hist_suspects": e["suspects"],
            "hist_unique": len(reps),
            "hist_violations": len(bad),
            "hist_undecided": int(undecided),
            "budget_exceeded": int(exhausted),
            "hist_violating_seeds": bad[: self._max_recorded],
        }


def history_host_work(
    spec,
    max_states: int = 200_000,
    workers: int = 0,
    max_recorded: int = 32,
    telemetry=None,
    device_decode: bool = False,
) -> _HostWork:
    """The ``host_work`` of a screened checked sweep (a ``_HostWork``)."""
    return _HostWork(spec, max_states, workers, max_recorded, telemetry, device_decode)


def checked_sweep(
    workload,
    cfg,
    seeds,
    spec,
    summarize,
    chunk_size: Optional[int] = None,
    workers: int = 0,
    max_states: int = 200_000,
    screen: bool = True,
    ckpt_dir: Optional[str] = None,
    stop_after: Optional[int] = None,
    resume_from=None,
    mesh=None,
    chunk_per_device: Optional[int] = None,
    max_recorded: int = 32,
    on_chunk=None,
    driver: str = "chunked",
    telemetry=None,
    device_decode: bool = False,
    device=None,
) -> dict:
    """End-to-end checked sweep: the pipelined chunked sweep
    (``engine.checkpoint.run_sweep_pipelined``), the screen on the device
    behind each chunk, and the WGL checker over a process pool on the
    suspect lanes, merged into one summary dict — the reference's report,
    byte for byte.

    ``screen=False`` decodes and checks every lane; the reports are equal
    whenever the screen is conservative, and equal across ``workers`` and
    ``device_decode`` always. ``chunk_size=None`` picks one with
    ``core.pick_chunk_size``. ``device=None`` means CUDA.

    ``driver="stream"`` routes the sweep through the lane pool
    (``engine.stream.stream_sweep``): the screen runs once per retirement
    cohort on the whole pool, and the flushed reports are byte-identical
    to the chunked driver's (same virtual chunk boundaries, same merge
    order). The stream keeps its own snapshots
    (``stream_sweep(ckpt_path=...)``), so ``ckpt_dir``/``stop_after``/
    ``resume_from`` are refused with it.

    ``mesh`` (a ``parallel.SeedMesh``; every rank calls with the same
    arguments) routes the pipeline through the sharded driver
    (``parallel.run_sweep_sharded_pipelined``): the sweep and the screen
    run sharded, the host phase (decode, dedup, WGL) once per chunk on
    rank 0 (so ``workers`` starts one pool, on rank 0), its verdict
    broadcast, chunks of ``chunk_per_device`` lanes per rank
    (``core.pick_chunk_size`` when omitted; an explicit ``chunk_size``
    stays GLOBAL and overrides), and every rank returns the same report,
    byte-identical across world sizes and to the reference's: counts are
    exact integer reductions merged in seed order, and the
    ``hist_violating_seeds`` sample composes — each chunk records at most
    ``max_recorded`` violators in lane order and the merge is capped to
    the same bound. With ``driver="stream"`` the lane pool is sharded
    (``stream_sweep(mesh=)``), its chunk rounded up to mesh divisibility."""
    from ..engine import core
    from ..engine.checkpoint import run_sweep_pipelined

    if driver not in ("chunked", "stream"):
        raise ValueError(f"unknown driver {driver!r}")
    if driver == "stream" and (ckpt_dir is not None or stop_after is not None or resume_from):
        raise ValueError(
            "driver='stream' manages its own snapshots — use "
            "engine.stream.stream_sweep(ckpt_path=...) directly for "
            "interrupt/resume"
        )
    screen_fn = None
    if screen:
        if screen_for(spec) is None:
            raise ValueError(
                f"spec {spec.name!r} has no device screen; pass "
                "screen=False to check every lane"
            )
        screen_fn = lambda final: screen_sweep(final, spec, mesh=mesh)  # noqa: E731
    host_work = history_host_work(
        spec, max_states=max_states, workers=workers,
        max_recorded=max_recorded, telemetry=telemetry,
        device_decode=device_decode,
    )
    if driver == "stream":
        from ..engine.stream import stream_sweep

        if chunk_size is None:
            if mesh is not None and chunk_per_device is not None:
                chunk_size = chunk_per_device * mesh.size
            elif mesh is not None:
                chunk_size = core.pick_chunk_size(workload, cfg) * mesh.size
            else:
                chunk_size = core.pick_chunk_size(workload, cfg)
        if mesh is not None:
            chunk_size = -(-chunk_size // mesh.size) * mesh.size
        totals = stream_sweep(
            workload, cfg, seeds, summarize,
            chunk_size=chunk_size, host_work=host_work, screen=screen_fn,
            mesh=mesh, on_chunk=on_chunk, telemetry=telemetry, device=device,
        )
    elif mesh is not None:
        from ..parallel.mesh import run_sweep_sharded_pipelined

        totals = run_sweep_sharded_pipelined(
            workload, cfg, seeds, summarize,
            mesh=mesh, host_work=host_work, screen=screen_fn,
            chunk_per_device=chunk_per_device, chunk_size=chunk_size,
            ckpt_dir=ckpt_dir, stop_after=stop_after,
            resume_from=resume_from, on_chunk=on_chunk,
            telemetry=telemetry,
        )
    else:
        if chunk_size is None:
            chunk_size = core.pick_chunk_size(workload, cfg)
        totals = run_sweep_pipelined(
            workload, cfg, seeds, summarize,
            host_work=host_work,
            screen=screen_fn,
            chunk_size=chunk_size,
            ckpt_dir=ckpt_dir,
            stop_after=stop_after,
            resume_from=resume_from,
            on_chunk=on_chunk,
            telemetry=telemetry,
            device=device,
        )
    if "hist_violating_seeds" in totals:
        totals["hist_violating_seeds"] = totals["hist_violating_seeds"][:max_recorded]
    return totals
