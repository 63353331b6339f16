"""Scale-out tier: the seed batch sharded over ranks (counterpart of
``madsim_tpu.parallel``).

Seeds are independent, so the only parallel axis is the seed batch: each
rank of a ``torch.distributed`` process group steps its own contiguous
shard, and the one collective on the step path is the sum of the live
counts that ends a sweep. ``mesh`` holds the drivers; ``world`` spawns
the processes that run them (``World(n)``).
"""

from .mesh import (
    SEED_AXIS,
    SeedMesh,
    all_sum,
    gather_rows,
    gather_state,
    mesh_layout,
    resume_sweep_sharded,
    run_sweep_sharded,
    run_sweep_sharded_chunked,
    run_sweep_sharded_pipelined,
    seed_mesh,
    shard_params,
    shard_seeds,
    shard_state,
    sharded_step,
    sub_mesh,
)
from .world import World

__all__ = [
    "SEED_AXIS",
    "SeedMesh",
    "World",
    "all_sum",
    "gather_rows",
    "gather_state",
    "mesh_layout",
    "resume_sweep_sharded",
    "run_sweep_sharded",
    "run_sweep_sharded_chunked",
    "run_sweep_sharded_pipelined",
    "seed_mesh",
    "shard_params",
    "shard_seeds",
    "shard_state",
    "sharded_step",
    "sub_mesh",
]
