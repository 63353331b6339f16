"""Sweep checkpoint/resume and the chunk drivers (counterpart of
``madsim_tpu/engine/checkpoint.py``).

A whole in-flight seed batch round-trips through one ``.npz`` file in
the reference's layout, so a snapshot written by either package resumes
in the other: the leaves in ``tree.leaves`` order (the reference's
``jax.tree.leaves`` order) as ``leaf_{i}``, the key leaf as its uint32
words ``leaf_{i}__key`` (which the reference reads back with
``jax.random.wrap_key_data``), bool leaves as bool, and the format
version in ``__version__``.

The chunk drivers — ``run_sweep_chunked_resumable`` and
``run_sweep_pipelined`` — write per-chunk summary files guarded by a
seed sha and a fingerprint of the workload. The fingerprint names the
module of the workload's ``init``, so a chunk directory of the reference
is refused here and the other way round; the ``.npz`` snapshots carry no
fingerprint and cross freely.

``telemetry=`` is duck-typed (``count``/``event``/``observe``/
``event_mix`` and an optional ``tracer``): every recorder sits behind an
``is not None`` guard and never touches a summary.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from . import core, tree
from .core import EngineConfig, EngineState, Workload

# The reference's format history: v6 split the fault state per direction,
# v7 added ``__inflight__`` chunk metadata, v8 ``__mesh_layout__``, v9
# stream snapshots, and v10 the trailing ``evmix`` leaf. Every leaf index
# before it is unchanged, so a v6-v9 file resumes a sweep whose event-mix
# plane is off (width 0) and is refused by one whose plane is on.
_FORMAT_VERSION = 10
_READABLE_VERSIONS = (6, 7, 8, 9, 10)


def _host_leaf(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy()


def _np_dtype(leaf: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=leaf.dtype).numpy().dtype


def _restore_leaf(data, i: int, leaf: torch.Tensor, path: str) -> torch.Tensor:
    """One positional leaf of a snapshot, on ``leaf``'s device. A missing
    trailing leaf is legal only where the resuming state expects a
    width-0 plane (``leaf.numel() == 0``); ``like``'s own leaf stands in."""
    if f"leaf_{i}__key" in data:
        a = np.asarray(data[f"leaf_{i}__key"], dtype=np.uint32)
    elif f"leaf_{i}" in data:
        a = np.asarray(data[f"leaf_{i}"], dtype=_np_dtype(leaf))
    elif leaf.numel() == 0:
        return leaf
    else:
        raise ValueError(
            f"{path} has no leaf_{i} but the resuming state expects a "
            f"non-empty array there (shape {tuple(leaf.shape)}) — a pre-v10 "
            "snapshot cannot resume an event-mix-enabled sweep "
            "(engine/core.py event_mix_kinds); re-run from scratch"
        )
    return torch.from_numpy(np.array(a)).to(leaf.device)


def save_sweep(
    state: EngineState,
    path: str,
    inflight: Optional[dict] = None,
    mesh_layout: Optional[dict] = None,
) -> None:
    """Serialize a batched EngineState to ``path`` (.npz, format v10).

    ``inflight`` (a JSON-able dict, at least ``{"lo": <chunk start>,
    "k": <real lanes>}``) tags the snapshot as the in-flight chunk of a
    pipelined sweep, so ``run_sweep_pipelined(resume_from=...)`` finishes
    that chunk from it; ``mesh_layout`` records a sharded driver's
    layout. Read them back with ``load_inflight``/``load_mesh_layout``."""
    import json

    arrays = {}
    for i, leaf in enumerate(tree.leaves(state)):
        if leaf is state.key:
            # the typed key's raw words, as the reference writes it
            arrays[f"leaf_{i}__key"] = _host_leaf(leaf).astype(np.uint32)
        else:
            arrays[f"leaf_{i}"] = _host_leaf(leaf)
    for name, meta in (("__inflight__", inflight), ("__mesh_layout__", mesh_layout)):
        if meta is not None:
            arrays[name] = np.frombuffer(
                json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8
            )
    np.savez_compressed(path, __version__=_FORMAT_VERSION, **arrays)


def _load_meta(path: str, name: str) -> Optional[dict]:
    import json

    data = np.load(path)
    if name not in data:
        return None
    return json.loads(bytes(bytearray(data[name])).decode())


def load_inflight(path: str) -> Optional[dict]:
    """The ``inflight`` chunk metadata of a v7+ snapshot, or None."""
    return _load_meta(path, "__inflight__")


def load_mesh_layout(path: str) -> Optional[dict]:
    """The mesh-layout metadata of a v8+ snapshot, or None."""
    return _load_meta(path, "__mesh_layout__")


def load_sweep(path: str, like: EngineState) -> EngineState:
    """Restore a checkpoint onto ``like``'s device; ``like`` supplies the
    tree structure and dtypes (``init_sweep`` of the same workload and
    config, any seeds)."""
    data = np.load(path)
    found = int(data["__version__"])
    if found not in _READABLE_VERSIONS:
        raise ValueError(
            f"checkpoint format version mismatch: {path} is v{found}, "
            f"this engine reads v{_READABLE_VERSIONS} (the draw layout / "
            "state schema changed between versions; re-run the sweep to "
            "produce a fresh checkpoint)"
        )
    out = [_restore_leaf(data, i, leaf, path) for i, leaf in enumerate(tree.leaves(like))]
    return tree.unflatten(like, out)


def save_stream(path: str, state: EngineState, *, pending: dict, susp: dict, meta: dict) -> None:
    """Serialize a streaming sweep's in-flight picture (format v9's
    stream snapshot; ``engine/stream.stream_sweep`` is the only writer),
    key for key and dtype for dtype the reference's layout:

    - the lane pool's ``EngineState`` as ``leaf_{i}`` / ``leaf_{i}__key``,
      as ``save_sweep`` writes it;
    - ``pending``: item index -> captured row leaves (host arrays, the key
      row as uint32 words) of results retired but not yet flushed, stacked
      per leaf as ``pend_{j}`` in item order;
    - ``susp``: item index -> device-screen suspect bit (absent when the
      stream runs unscreened);
    - ``meta``: the stream's JSON bookkeeping, stored with ``items`` and
      ``susp`` in the ``__stream__`` tag."""
    import json

    leaves = tree.leaves(state)
    arrays = {}
    for i, leaf in enumerate(leaves):
        if leaf is state.key:
            arrays[f"leaf_{i}__key"] = _host_leaf(leaf).astype(np.uint32)
        else:
            arrays[f"leaf_{i}"] = _host_leaf(leaf)
    items = sorted(int(i) for i in pending)
    if items:
        for j in range(len(leaves)):
            arrays[f"pend_{j}"] = np.stack([np.asarray(pending[it][j]) for it in items])
    stream_meta = dict(meta)
    stream_meta["items"] = items
    stream_meta["susp"] = [(None if it not in susp else bool(susp[it])) for it in items]
    arrays["__stream__"] = np.frombuffer(
        json.dumps(stream_meta, sort_keys=True).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, __version__=_FORMAT_VERSION, **arrays)


def load_stream(path: str, like: EngineState):
    """Restore a stream snapshot: ``(pool state on like's device, pending
    rows dict, suspect-bit dict, stream meta)``. ``like`` supplies the
    tree structure and dtypes (an ``init_sweep`` of the same pool
    shape)."""
    import json

    data = np.load(path)
    found = int(data["__version__"])
    if found not in _READABLE_VERSIONS or "__stream__" not in data:
        raise ValueError(
            f"{path} is not a readable stream snapshot (v{found}"
            f"{', no __stream__ tag' if '__stream__' not in data else ''}); "
            "stream snapshots are checkpoint format v9 "
            "(engine/stream.stream_sweep ckpt_path=)"
        )
    like_leaves = tree.leaves(like)
    out = [_restore_leaf(data, i, leaf, path) for i, leaf in enumerate(like_leaves)]
    state = tree.unflatten(like, out)
    meta = json.loads(bytes(bytearray(data["__stream__"])).decode())
    # each stacked plane read (and decompressed) once; a pre-v10 snapshot
    # has no pend_{j} for the trailing event-mix leaf, and only a width-0
    # plane may be missing (_restore_leaf has refused a non-empty gap)
    items = meta["items"]
    planes = [
        data[f"pend_{j}"] if f"pend_{j}" in data
        else np.zeros((len(items),) + tuple(out[j].shape[1:]), _np_dtype(out[j]))
        for j in range(len(like_leaves))
    ] if items else []
    pending, susp = {}, {}
    for idx, it in enumerate(items):
        pending[int(it)] = [plane[idx] for plane in planes]
        bit = meta["susp"][idx]
        if bit is not None:
            susp[int(it)] = bool(bit)
    return state, pending, susp, meta


def resume_sweep(workload: Workload, cfg: EngineConfig, state: EngineState) -> EngineState:
    """Continue a (possibly restored) sweep on its device until every
    seed finishes."""
    return core.drive(workload, cfg, state)


def _chunk_sha(seeds_host: np.ndarray, lo: int, k: int) -> str:
    """Identity of one chunk's full seed slice (endpoints alone collide)."""
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(seeds_host[lo : lo + k]).tobytes()).hexdigest()


def _load_chunk_summary(path: str, first: int, last: int, sha: str, fp: str) -> dict:
    """Validate a per-chunk checkpoint file against this sweep's identity
    and return its summary (a record without ``seeds_sha256`` still
    passes on its endpoints and fingerprint)."""
    import json

    with open(path) as f:
        rec = json.load(f)
    if (
        rec["first_seed"] != first
        or rec["last_seed"] != last
        or rec.get("seeds_sha256", sha) != sha
        or rec.get("fingerprint") != fp
    ):
        raise ValueError(
            f"checkpoint {path} is from a different sweep: holds "
            f"seeds [{rec['first_seed']}, {rec['last_seed']}] "
            f"(sha {rec.get('seeds_sha256')!r}) with "
            f"fingerprint {rec.get('fingerprint')!r}, expected "
            f"[{first}, {last}] (sha {sha!r}) with {fp!r}"
        )
    return rec["summary"]


def _write_chunk_summary(path: str, first: int, last: int, sha: str, fp: str, summary: dict) -> None:
    """Atomically write one chunk's record (tmp + rename). The tmp name
    is the writer's own: the ranks of a mesh write the same record."""
    import json
    import os

    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(
            {
                "first_seed": first,
                "last_seed": last,
                "seeds_sha256": sha,
                "fingerprint": fp,
                "summary": summary,
            },
            f,
            sort_keys=True,
        )
    os.replace(tmp, path)


def params_digest(params) -> str:
    """Candidate identity of a per-lane spec-as-data tree: a sha256 over
    every leaf's dtype, shape and bytes (the reference's digest for equal
    arrays), appended to the fingerprint so one candidate's chunk files
    never merge into another's sweep."""
    import hashlib

    h = hashlib.sha256()
    for leaf in tree.leaves(params):
        a = np.ascontiguousarray(
            _host_leaf(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        )
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _seeds(seeds) -> Tuple[torch.Tensor, np.ndarray, int]:
    s = core._seed_tensor(seeds, "cpu")
    n = int(s.shape[0])
    if n == 0:
        raise ValueError("seed batch is empty")
    return s, s.numpy(), n


def _default_run_chunk(workload, cfg, params, dev):
    if params is None:
        return lambda chunk: core.run_sweep(workload, cfg, chunk, device=dev)
    return lambda chunk, pchunk: core.run_sweep(workload, cfg, chunk, device=dev, params=pchunk)


def _fingerprint(workload, cfg, params) -> str:
    fp = _sweep_fingerprint(workload, cfg)
    if params is not None:
        fp += "|params" + params_digest(params)
    return fp


def run_sweep_chunked_resumable(
    workload: Workload,
    cfg: EngineConfig,
    seeds,
    summarize,
    ckpt_dir: str,
    chunk_size: int = 16384,
    run_chunk: Optional[Callable] = None,
    params=None,
    telemetry=None,
    device=None,
) -> dict:
    """A sweep that survives interruption at chunk granularity: each
    chunk's ``summarize(final)`` dict is written atomically to
    ``ckpt_dir``, and a restarted call skips every chunk whose file
    exists (chunks are deterministic). Returns the merged totals.

    Each file records its seed range, a sha256 of the chunk's seeds and
    the workload's fingerprint; a file of another sweep raises. A ragged
    final chunk runs as it is, unpadded. ``run_chunk(seed_chunk)``
    overrides the per-chunk sweep; ``device=None`` means CUDA."""
    import os
    import time as _time

    from ..models._common import merge_summaries

    dev = resolve_device(device)
    if run_chunk is None:
        run_chunk = _default_run_chunk(workload, cfg, params, dev)
    seeds, seeds_host, n = _seeds(seeds)
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    fp = _fingerprint(workload, cfg, params)
    os.makedirs(ckpt_dir, exist_ok=True)
    totals: dict = {}
    for lo in range(0, n, chunk_size):
        k = min(chunk_size, n - lo)
        first, last = int(seeds_host[lo]), int(seeds_host[lo + k - 1])
        seeds_sha = _chunk_sha(seeds_host, lo, k)
        path = os.path.join(ckpt_dir, f"chunk_{lo:010d}_{k}.json")
        if os.path.exists(path):
            summary = _load_chunk_summary(path, first, last, seeds_sha, fp)
            if telemetry is not None:
                telemetry.count("sweep_chunks_skipped_total")
                telemetry.event("chunk_skipped", lo=lo, k=k)
        else:
            if telemetry is not None:
                t_chunk = _time.perf_counter()
            summary = summarize(core.run_padded(run_chunk, seeds, lo, chunk_size, 0, params))
            _write_chunk_summary(path, first, last, seeds_sha, fp, summary)
            if telemetry is not None:
                dt = _time.perf_counter() - t_chunk
                telemetry.observe(
                    "sweep_chunk_seconds", dt, help="device+summary wall time per chunk"
                )
                telemetry.count("sweep_chunks_total")
                telemetry.event("chunk", lo=lo, k=k, wall_s=round(dt, 6))
        if telemetry is not None:
            telemetry.count("sweep_seeds_done_total", k, help="seeds merged so far")
            telemetry.event_mix(summary)
        merge_summaries(totals, summary)
    return totals


def run_sweep_pipelined(
    workload: Workload,
    cfg: EngineConfig,
    seeds,
    summarize,
    *,
    host_work: Optional[Callable] = None,
    screen: Optional[Callable] = None,
    chunk_size: int = 16384,
    ckpt_dir: Optional[str] = None,
    stop_after: Optional[int] = None,
    resume_from: Optional[Tuple[EngineState, dict]] = None,
    run_chunk: Optional[Callable] = None,
    resume_chunk: Optional[Callable] = None,
    pad_multiple: int = 1,
    on_chunk: Optional[Callable] = None,
    params=None,
    telemetry=None,
    device=None,
) -> dict:
    """Chunked sweep with the host phase of chunk N run after the device
    phase of chunk N+1 — the reference's order of work, chunk for chunk,
    but not its overlap: ``core.drive`` waits for the card every 64
    steps, so chunk N+1 has finished on the card before chunk N's host
    phase starts, and the two phases add up. (The reference's host phase
    runs while XLA's asynchronous dispatch keeps the device busy.)

    Per chunk: the sweep (``run_chunk``) and ``screen(final) -> bool[S]``
    run; then the previous chunk's host phase runs —
    ``host_work(final, lo=, n=, seeds=, suspect=, summary=)`` gets its
    finished state (padded lanes trimmed), its suspect mask on the host
    and its summary, and the dict it returns joins that summary; then
    this chunk's ``summarize`` reads its result. Every chunk is padded
    to the next ``pad_multiple`` of lanes (a ragged final chunk is not
    padded to ``chunk_size``: no compiled program is reused here); a
    limit-aware ``summarize`` masks the padded lanes, and ``host_work``
    never sees them.

    ``ckpt_dir`` writes each chunk's final summary (after its host
    phase) atomically and skips chunks already written, as
    ``run_sweep_chunked_resumable`` does; ``stop_after`` returns after
    that many chunks were computed in this call; ``resume_from=(state,
    inflight)`` — a snapshot written by ``save_sweep(state, path,
    inflight={"lo": ..., "k": ...})`` — finishes that chunk from its
    saved state. Summaries merge in seed order, so the totals are the
    same bytes across pipelining, worker counts and interruptions.

    A ``host_work`` with ``incremental = True`` (``oracle.screen``'s) is
    driven through ``submit``/``poll``/``drain``, its checking sliced
    under a budget of the device phase's EMA wall time, except under
    ``ckpt_dir``/``stop_after``/``resume_from``, whose chunk files need
    each summary final at its own boundary. ``run_chunk(seed_chunk)`` and
    ``resume_chunk(state)`` replace the per-chunk sweep and resume;
    ``on_chunk(lo=, k=, summary=)`` fires as each chunk merges;
    ``params`` are per-lane spec-as-data, sliced and edge-padded per
    chunk and joined to the fingerprint. ``device=None`` means CUDA."""
    import os
    import time as _time

    from ..models._common import merge_summaries

    dev = resolve_device(device)
    if run_chunk is None:
        run_chunk = _default_run_chunk(workload, cfg, params, dev)
    if resume_chunk is None:
        resume_chunk = lambda state: core.drive(workload, cfg, state)  # noqa: E731
    seeds, seeds_host, n = _seeds(seeds)
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    fp = _fingerprint(workload, cfg, params)
    if ckpt_dir is not None:
        os.makedirs(ckpt_dir, exist_ok=True)
    supports_limit = bool(getattr(summarize, "supports_limit", False))
    resume_lo = int(resume_from[1]["lo"]) if resume_from is not None else -1
    tracer = telemetry.tracer if telemetry is not None else None

    totals: dict = {}
    pending = None  # previous chunk awaiting its host phase
    computed = 0
    incr = (
        host_work is not None
        and getattr(host_work, "incremental", False)
        and ckpt_dir is None
        and stop_after is None
        and resume_from is None
    )
    deferred: dict = {}  # lo -> (k, base summary) awaiting a verdict
    ema = 0.0

    def suspect_of(susp, k):
        if susp is None:
            return None
        return (susp.detach().cpu().numpy() if isinstance(susp, torch.Tensor)
                else np.asarray(susp))[:k]

    def absorb(finished) -> None:
        for flo, extra in finished:
            fk, summary = deferred.pop(flo)
            if extra:
                summary = {**summary, **extra}
            merge_summaries(totals, summary)
            if telemetry is not None:
                telemetry.count("sweep_chunks_total")
                telemetry.count("sweep_seeds_done_total", fk, help="seeds merged so far")
                telemetry.event_mix(summary)
                telemetry.event("chunk", lo=flo, k=fk)
            if on_chunk is not None:
                on_chunk(lo=flo, k=fk, summary=summary)

    def submit_pending(p, budget: float) -> None:
        lo, k, _sha, final, susp, summary, _path = p
        if telemetry is not None:
            t_host = _time.perf_counter()
            h0 = tracer._now_us() if tracer is not None else 0.0
        deferred[lo] = (k, summary)
        host_work.submit(
            final, lo=lo, n=k, seeds=seeds_host[lo : lo + k],
            suspect=suspect_of(susp, k), summary=summary,
        )
        absorb(host_work.poll(budget))
        if telemetry is not None:
            telemetry.observe(
                "sweep_host_phase_seconds", _time.perf_counter() - t_host,
                help="host phase (decode/check/ckpt write) per chunk",
            )
            if tracer is not None:
                # the reference traces no host span on this path; the
                # port's shows each chunk's submit and budgeted check
                tracer.complete(
                    f"host check lo={lo}", h0, tracer._now_us() - h0,
                    track="host", args={"lo": lo, "k": k},
                )

    def flush(p) -> None:
        lo, k, sha, final, susp, summary, path = p
        if telemetry is not None:
            t_host = _time.perf_counter()
            h0 = tracer._now_us() if tracer is not None else 0.0
        if host_work is not None:
            extra = host_work(
                final, lo=lo, n=k, seeds=seeds_host[lo : lo + k],
                suspect=suspect_of(susp, k), summary=summary,
            )
            if extra:
                summary = {**summary, **extra}
        if path is not None:
            _write_chunk_summary(
                path, int(seeds_host[lo]), int(seeds_host[lo + k - 1]), sha, fp, summary
            )
        merge_summaries(totals, summary)
        if telemetry is not None:
            dt = _time.perf_counter() - t_host
            telemetry.observe(
                "sweep_host_phase_seconds", dt,
                help="host phase (decode/check/ckpt write) per chunk",
            )
            telemetry.count("sweep_chunks_total")
            telemetry.count("sweep_seeds_done_total", k, help="seeds merged so far")
            telemetry.event_mix(summary)
            telemetry.event("chunk", lo=lo, k=k, host_phase_s=round(dt, 6))
            if tracer is not None:
                tracer.complete(
                    f"host flush lo={lo}", h0, tracer._now_us() - h0,
                    track="host", args={"lo": lo, "k": k},
                )
        if on_chunk is not None:
            on_chunk(lo=lo, k=k, summary=summary)

    for lo in range(0, n, chunk_size):
        k = min(chunk_size, n - lo)
        sha = _chunk_sha(seeds_host, lo, k)
        path = (
            os.path.join(ckpt_dir, f"pchunk_{lo:010d}_{k}.json")
            if ckpt_dir is not None else None
        )
        if path is not None and os.path.exists(path):
            summary = _load_chunk_summary(
                path, int(seeds_host[lo]), int(seeds_host[lo + k - 1]), sha, fp
            )
            if pending is not None:
                flush(pending)  # keep merge order = seed order
                pending = None
            merge_summaries(totals, summary)
            if telemetry is not None:
                telemetry.count("sweep_chunks_skipped_total")
                telemetry.count("sweep_seeds_done_total", k)
                telemetry.event_mix(summary)
                telemetry.event("chunk_skipped", lo=lo, k=k)
            if on_chunk is not None:
                on_chunk(lo=lo, k=k, summary=summary)
            continue

        # -- device phase: this chunk's sweep (+ screen) ----------------
        if telemetry is not None or incr:
            t_disp = _time.perf_counter()
        if telemetry is not None:
            d0 = tracer._now_us() if tracer is not None else 0.0
        pad = -k % pad_multiple
        if lo == resume_lo:
            state, inflight = resume_from
            if telemetry is not None:
                telemetry.count("sweep_resume_total", help="mid-chunk snapshot resumes")
                telemetry.event("chunk_resumed", lo=lo, k=k)
            if int(inflight.get("k", k)) != k or not np.array_equal(
                state.seed.detach().cpu().numpy()[:k], seeds_host[lo : lo + k]
            ):
                raise ValueError(
                    f"resume_from snapshot does not match chunk at {lo}: "
                    f"inflight={inflight!r}"
                )
            # the snapshot carries its own padding: trust its lane count
            pad = int(state.seed.shape[0]) - k
            final = resume_chunk(state)
        else:
            final = core.run_padded(run_chunk, seeds, lo, chunk_size, pad, params)
        susp = screen(final) if screen is not None else None

        # -- previous chunk's host phase --------------------------------
        if pending is not None:
            if incr:
                submit_pending(pending, ema)
            else:
                flush(pending)
            pending = None

        # -- this chunk's summary ---------------------------------------
        if pad and supports_limit:
            summary = summarize(final, limit=k)
        else:
            if pad:
                final = core._concat_finals(k, final)
            summary = summarize(final)
        if pad and supports_limit and host_work is not None:
            # the host phase never sees the padded lanes
            final = core._concat_finals(k, final)
        if susp is not None and pad:
            susp = susp[:k]
        if telemetry is not None or incr:
            dt = _time.perf_counter() - t_disp
            ema = dt if ema == 0.0 else 0.5 * ema + 0.5 * dt
        if telemetry is not None:
            telemetry.observe(
                "sweep_chunk_seconds", dt, help="device phase (dispatch -> summary) per chunk"
            )
            if tracer is not None:
                tracer.complete(
                    f"device chunk lo={lo}", d0, tracer._now_us() - d0,
                    track="device", args={"lo": lo, "k": k},
                )
        pending = (lo, k, sha, final, susp, summary, path)
        computed += 1
        if stop_after is not None and computed >= stop_after:
            break

    if pending is not None:
        if incr:
            submit_pending(pending, 0.0)
        else:
            flush(pending)
    if incr:
        absorb(host_work.drain())
    return totals


# EngineConfig fields that select equivalent layouts: schedules and
# summaries are equal across their values, so they do not invalidate
# resumable checkpoints
_LAYOUT_ONLY_FIELDS = frozenset({"legacy_queue", "cond_interval"})


def _sweep_fingerprint(workload: Workload, cfg: EngineConfig) -> str:
    """Identity of (model, model config, engine config) for the chunk
    files' stale-checkpoint guard: the module and name of the workload's
    ``init``, its bound config's repr, the engine config without its
    layout-only fields, and the coverage, history and event-mix widths
    (each changes a summary's schema or values)."""
    init = workload.init
    fn = getattr(init, "func", init)
    args = getattr(init, "args", ())
    cfg_id = tuple(v for f, v in zip(cfg._fields, cfg) if f not in _LAYOUT_ONLY_FIELDS)
    return (
        f"{fn.__module__}.{fn.__qualname__}|{args!r}|{cfg_id!r}"
        f"|cover{workload.cover_bits}|hist{core.hist_slots(workload)}"
        f"|emix{workload.event_mix_kinds}"
    )
