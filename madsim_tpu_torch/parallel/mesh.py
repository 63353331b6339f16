"""The seed batch sharded over ranks (counterpart of
``madsim_tpu/parallel/mesh.py``).

The reference shards the batched state over a ``jax.sharding.Mesh`` axis
named ``"seeds"`` and runs the step under ``shard_map``. Here the same
data parallelism is SPMD over ``torch.distributed``: one process per
rank, each holding the contiguous shard ``[r*S/n, (r+1)*S/n)`` of a
batch (the layout of the reference's ``P("seeds")``) on its own device,
and every function below is called by every rank of the group with the
same arguments.

- per rank: ``core.step_batch`` over the local shard;
- across ranks: the sum of the local live counts, read once per
  ``core.CHECK_EVERY`` steps (the reference psums it every step inside
  its device loop). That is exact: a done lane is a frozen no-op, so the
  at most 63 extra steps after the last seed finishes change nothing,
  and the step count never passes ``max_steps``;
- at the end, the shards are gathered, so every rank returns the whole
  batch's state, equal to an unsharded ``core.run_sweep``.

A ``SeedMesh`` names the process group, the rank, the world size and the
rank's device. Its backend is explicit: ``nccl`` when each rank has a
card of its own, ``gloo`` when ranks share a card or run on the CPU —
then counts and gathered rows travel through host tensors. gloo carries
no uint32 and NCCL no bool, so uint32 leaves travel as their int32 bits
and bool as uint8. ``seed_mesh()`` outside a process group is the
one-rank mesh, whose collectives are no-ops; nothing falls back to it
when a group exists.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..engine import core, tree
from ..engine.core import EngineConfig, EngineState, Workload
from ..engine.ops import U32

SEED_AXIS = "seeds"


class SeedMesh(NamedTuple):
    """One rank's view of the seed mesh."""

    group: object  # a torch.distributed ProcessGroup, None for one rank
    rank: int
    size: int
    device: torch.device
    backend: str  # "nccl", "gloo", or "" without a process group

    def shard(self, total: int) -> Tuple[int, int]:
        """``(lo, m)``: this rank's lanes ``[lo, lo + m)`` of a
        ``total``-lane batch (which must divide the world size)."""
        if total % self.size:
            raise ValueError(
                f"a {total}-lane batch does not divide the {self.size}-rank "
                "seed mesh (pad it, or use run_sweep_sharded_chunked)"
            )
        m = total // self.size
        return self.rank * m, m


def seed_mesh(device=None) -> SeedMesh:
    """The seed mesh over the default process group, on this rank's
    ``device`` (None means CUDA); without an initialised process group,
    the one-rank mesh (``sub_mesh`` makes a mesh of fewer ranks).

    NCCL needs a card per rank: a group with more ranks than visible
    cards, or a CPU device, raises (share a card over gloo instead)."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        return SeedMesh(None, 0, 1, dev, "")
    group = dist.group.WORLD
    backend = str(dist.get_backend(group))
    size = dist.get_world_size(group)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, not {dev}")
        if size > torch.cuda.device_count():
            raise ValueError(
                f"nccl with {size} ranks on {torch.cuda.device_count()} card(s): "
                "NCCL needs a card per rank; share a card over gloo"
            )
    return SeedMesh(group, dist.get_rank(group), size, dev, backend)


_SUB_GROUPS: dict = {}  # (parent group, n) -> the process group of ranks 0..n-1


def sub_mesh(mesh: SeedMesh, n: int) -> Optional[SeedMesh]:
    """The mesh of ranks ``0..n-1`` of ``mesh``. A collective call the
    first time for a ``(mesh, n)``: every rank of the default process
    group makes it (``new_group``'s rule); the group is kept and reused
    after that. Ranks outside the new mesh get None."""
    import torch.distributed as dist

    if not 1 <= n <= mesh.size:
        raise ValueError(f"need {n} ranks, the mesh has {mesh.size}")
    if n == mesh.size or mesh.group is None:
        return mesh
    key = (mesh.group, n)
    if key not in _SUB_GROUPS:
        ranks = [dist.get_global_rank(mesh.group, r) for r in range(n)]
        _SUB_GROUPS[key] = dist.new_group(ranks, backend=mesh.backend)
    if mesh.rank >= n:
        return None
    return SeedMesh(_SUB_GROUPS[key], mesh.rank, n, mesh.device, mesh.backend)


def _wire_device(mesh: SeedMesh) -> torch.device:
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def all_sum(mesh: SeedMesh, value: int) -> int:
    """The sum of an integer over the mesh's ranks."""
    import torch.distributed as dist

    if mesh.group is None:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_wire_device(mesh))
    dist.all_reduce(t, group=mesh.group)
    return int(t.item())


def gather_rows(mesh: SeedMesh, local: torch.Tensor) -> torch.Tensor:
    """The ranks' equal-sized shards of one leaf, concatenated in rank
    order along the seed axis, on this rank's device."""
    import torch.distributed as dist

    if mesh.group is None:
        return local
    dtype = local.dtype
    wire = local.contiguous()
    if dtype == U32:
        wire = wire.view(torch.int32)
    elif dtype == torch.bool:
        wire = wire.to(torch.uint8)
    wire = wire.to(_wire_device(mesh))
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire, group=mesh.group)
    out = torch.cat(parts).to(mesh.device)
    if dtype == U32:
        return out.view(U32)
    if dtype == torch.bool:
        return out.to(torch.bool)
    return out


def gather_state(mesh: SeedMesh, local):
    """Every leaf of a sharded state tree gathered (see ``gather_rows``)."""
    return tree.map(lambda a: gather_rows(mesh, a), local)


def from_rank0(mesh: SeedMesh, value):
    """Rank 0's ``value`` (any picklable object) on every rank of ``mesh``."""
    if mesh.group is None:
        return value
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(
        box, src=dist.get_global_rank(mesh.group, 0), group=mesh.group,
        device=mesh.device if mesh.backend == "nccl" else None,
    )
    return box[0]


def rank0_host_work(mesh: SeedMesh, host_work: Optional[Callable]) -> Optional[Callable]:
    """A chunk's host phase run once, on rank 0, its result broadcast:
    ``host_work(final, **kw)`` on rank 0 and the dict it returns on every
    rank, so ``n`` ranks do one rank's decode and checking (and start one
    checker pool). The host phase's ``hist_unique`` dedups over the whole
    chunk, so it cannot be split over the ranks' shards. The wrapper is
    synchronous: a driver calls it once per chunk, never through the
    incremental ``submit``/``poll`` protocol; the reports are equal
    either way. A one-rank mesh keeps ``host_work`` as it is."""
    if host_work is None or mesh.size == 1:
        return host_work

    def run(final, **kw):
        return from_rank0(mesh, host_work(final, **kw) if mesh.rank == 0 else None)

    return run


def _local(mesh: SeedMesh, a, lo: int, m: int):
    """Rows ``[lo, lo + m)`` of a host array or tensor, on the mesh's
    device (numpy stays numpy: init places params itself)."""
    if isinstance(a, torch.Tensor):
        return a[lo:lo + m].to(mesh.device)
    return np.asarray(a)[lo:lo + m]


def shard_seeds(mesh: SeedMesh, seeds) -> torch.Tensor:
    """This rank's shard of a seed vector (int64, on the rank's device);
    the batch must divide the world size."""
    seeds = core._seed_tensor(seeds, "cpu")
    lo, m = mesh.shard(int(seeds.shape[0]))
    return seeds[lo:lo + m].to(mesh.device)


def shard_params(mesh: SeedMesh, params):
    """This rank's rows of a per-lane spec-as-data tree (every leaf's
    leading axis is the lane batch, as in ``shard_state``)."""
    lo, m = mesh.shard(int(tree.leaves(params)[0].shape[0]))
    return tree.map(lambda a: _local(mesh, a, lo, m), params)


def shard_state(mesh: SeedMesh, state: EngineState) -> EngineState:
    """This rank's rows of a whole batched state, on its device — how a
    restored snapshot (host arrays with no layout) is resharded onto
    whatever mesh the resuming process has."""
    lo, m = mesh.shard(int(state.seed.shape[0]))
    return tree.map(lambda a: a[lo:lo + m].to(mesh.device), state)


def _drive(workload: Workload, cfg: EngineConfig, mesh: SeedMesh, state: EngineState):
    """``core.drive`` over the local shard, ended by the mesh-wide live
    count, so every rank runs the same number of steps."""
    return core.drive(workload, cfg, state,
                      live=lambda s: all_sum(mesh, int((~s.done).sum())))


def sharded_step(workload: Workload, cfg: EngineConfig, mesh: SeedMesh):
    """An explicit n-step sharded step: ``step(local_state, n_steps) ->
    (local_state, live)`` advances every local seed ``n_steps`` events and
    returns the mesh-wide number of still-live seeds. The dry run's
    demonstration of one sharded step and its collective; the sweeps use
    ``run_sweep_sharded``."""

    def step(state: EngineState, n_steps) -> Tuple[EngineState, int]:
        for _ in range(int(n_steps)):
            state = core.step_batch(workload, cfg, state, device=state.now_ns.device)
        return state, all_sum(mesh, int((~state.done).sum()))

    return step


def run_sweep_sharded(
    workload: Workload, cfg: EngineConfig, seeds, mesh: Optional[SeedMesh] = None,
    params=None, device=None,
) -> EngineState:
    """A seed sweep sharded over the mesh, equal per seed to
    ``core.run_sweep``; every rank returns the whole batch. The batch
    must divide the world size (``ValueError`` otherwise). ``params`` is
    per-lane spec-as-data, sharded alongside the seeds; ``device`` is
    used only to build the default mesh."""
    if mesh is None:
        mesh = seed_mesh(device=device)
    local = core.init_sweep(
        workload, cfg, shard_seeds(mesh, seeds), device=mesh.device,
        params=None if params is None else shard_params(mesh, params),
    )
    return gather_state(mesh, _drive(workload, cfg, mesh, local))


def run_sweep_sharded_chunked(
    workload: Workload,
    cfg: EngineConfig,
    seeds,
    mesh: Optional[SeedMesh] = None,
    chunk_per_device: int = 16384,
    params=None,
    device=None,
) -> EngineState:
    """The two scaling axes composed: the batch runs as sequential chunks
    of ``chunk_per_device x world size`` lanes, each sharded over the
    mesh; a ragged chunk is padded to mesh divisibility with
    continuation seeds and trimmed. Equal per seed to ``core.run_sweep``."""
    if mesh is None:
        mesh = seed_mesh(device=device)
    if params is None:
        run_chunk = lambda chunk: run_sweep_sharded(workload, cfg, chunk, mesh)  # noqa: E731
    else:
        run_chunk = lambda chunk, pchunk: run_sweep_sharded(  # noqa: E731
            workload, cfg, chunk, mesh, params=pchunk
        )
    return core.run_in_chunks(
        run_chunk, seeds, chunk_per_device * mesh.size, multiple=mesh.size, params=params
    )


def resume_sweep_sharded(
    workload: Workload, cfg: EngineConfig, state: EngineState,
    mesh: Optional[SeedMesh] = None, device=None,
) -> EngineState:
    """Continue a (possibly restored) sweep sharded over the mesh until
    every seed finishes; equal per seed to ``checkpoint.resume_sweep``.
    The batch must divide the world size."""
    if mesh is None:
        mesh = seed_mesh(device=device)
    if int(state.seed.shape[0]) % mesh.size:
        raise ValueError(
            f"cannot resume a {int(state.seed.shape[0])}-lane snapshot on "
            f"a {mesh.size}-rank mesh (batch must divide the mesh; resume "
            "on a divisor mesh or unsharded)"
        )
    return gather_state(mesh, _drive(workload, cfg, mesh, shard_state(mesh, state)))


def mesh_layout(mesh: SeedMesh, chunk_per_device: int) -> dict:
    """The mesh layout a sharded sweep records in its v8 snapshots
    (``checkpoint.save_sweep(mesh_layout=)``): enough to rebuild the
    global chunk boundaries on a resuming mesh of another size. The
    reference's keys and values."""
    return {
        "n_dev": int(mesh.size),
        "chunk_per_device": int(chunk_per_device),
        "chunk_size": int(chunk_per_device) * int(mesh.size),
        "axis": SEED_AXIS,
    }


def run_sweep_sharded_pipelined(
    workload: Workload,
    cfg: EngineConfig,
    seeds,
    summarize,
    *,
    mesh: Optional[SeedMesh] = None,
    host_work: Optional[Callable] = None,
    screen: Optional[Callable] = None,
    chunk_per_device: Optional[int] = None,
    chunk_size: Optional[int] = None,
    ckpt_dir: Optional[str] = None,
    stop_after: Optional[int] = None,
    resume_from: Optional[Tuple[EngineState, dict]] = None,
    on_chunk: Optional[Callable] = None,
    params=None,
    telemetry=None,
    device=None,
) -> dict:
    """The pipelined checked-sweep driver
    (``checkpoint.run_sweep_pipelined``) over the mesh: each chunk's
    sweep runs sharded (``run_sweep_sharded``) and is gathered to every
    rank; each rank screens its own lanes and summarises the chunk, and
    the host phase (decode, dedup, check) runs once, on rank 0, its
    verdict broadcast (``rank0_host_work``), so every rank returns the
    same totals.

    The global chunk is ``chunk_per_device x world size`` lanes
    (``chunk_per_device`` from ``core.pick_chunk_size`` when not given);
    an explicit global ``chunk_size`` overrides both, rounded up to mesh
    divisibility. The merged summary is byte-identical across world
    sizes and to the reference's. A mid-chunk v8 snapshot
    (``save_sweep(..., inflight=, mesh_layout=mesh_layout(mesh, cpd))``)
    resumes on any mesh whose size divides the chunk
    (``resume_from=(state, inflight)``). Every rank writes the same
    chunk files under ``ckpt_dir``.

    ``telemetry`` (duck-typed, ``gauge``) rides through to the inner
    driver and adds a ``mesh_devices`` gauge and a per-rank seeds/s gauge
    sampled at each chunk merge."""
    import time as _time

    from ..engine.checkpoint import run_sweep_pipelined

    if mesh is None:
        mesh = seed_mesh(device=device)
    n_dev = mesh.size
    if chunk_size is None:
        if chunk_per_device is None:
            one_lane = None if params is None else tree.map(lambda a: a[0], params)
            chunk_per_device = core.pick_chunk_size(workload, cfg, params=one_lane)
        chunk_size = chunk_per_device * n_dev
    chunk_size = -(-chunk_size // n_dev) * n_dev  # mesh divisibility

    if params is None:
        run_chunk = lambda chunk: run_sweep_sharded(workload, cfg, chunk, mesh)  # noqa: E731
    else:
        run_chunk = lambda chunk, pchunk: run_sweep_sharded(  # noqa: E731
            workload, cfg, chunk, mesh, params=pchunk
        )
    if telemetry is not None:
        telemetry.gauge("mesh_devices", n_dev, help="devices in the sweep mesh")
        inner_on_chunk = on_chunk
        t_last = [_time.perf_counter()]

        def on_chunk(lo, k, summary):
            now = _time.perf_counter()
            dt, t_last[0] = now - t_last[0], now
            telemetry.gauge(
                "mesh_seeds_per_s_per_device", k / max(dt, 1e-9) / n_dev,
                help="chunk-merge throughput divided by device count",
            )
            if inner_on_chunk is not None:
                inner_on_chunk(lo=lo, k=k, summary=summary)

    return run_sweep_pipelined(
        workload, cfg, seeds, summarize,
        host_work=rank0_host_work(mesh, host_work),
        screen=screen,
        chunk_size=chunk_size,
        ckpt_dir=ckpt_dir,
        stop_after=stop_after,
        resume_from=resume_from,
        run_chunk=run_chunk,
        resume_chunk=lambda state: resume_sweep_sharded(workload, cfg, state, mesh),
        pad_multiple=n_dev,
        on_chunk=on_chunk,
        params=params,
        telemetry=telemetry,
        device=mesh.device,
    )
