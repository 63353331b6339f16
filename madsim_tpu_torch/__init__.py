"""PyTorch/CUDA port of the batched simulation engine (``madsim_tpu``).

The JAX package ``madsim_tpu`` is the reference: every function here is
held to it bit for bit (the engine is integer-only, so parity is exact).
This package imports ``torch`` and numpy only — never ``jax`` and nothing
of ``madsim_tpu``.

Layout mirrors the reference: ``engine/`` (rng, ops, queue, core, net,
faults, checkpoint, the streaming lane pool ``stream``, the pop-min and
megasweep CUDA kernels), ``models/`` (raft, etcd, kafka, s3), ``oracle/``
(the history decoder, the sequential specs, the WGL checker and the
device screens behind ``checked_sweep``), ``parallel/`` (the seed mesh:
sharded sweeps over ``torch.distributed`` ranks, and ``World``, which
spawns them), ``explore/`` (the coverage-guided campaign loop: targets,
triage, shrink, campaign, fleet, the steered scheduler, the fleet store
and orchestrator, and the device half of the host↔device differential),
``replay`` (its host helpers) and ``entry`` (a one-step check and the
multi-rank dry run).

Every entry point takes ``device=None``; ``None`` means CUDA and raises
when no GPU is present — it never falls back to the CPU. Pass
``device="cpu"`` explicitly to run the plain torch path on the host.

``torch`` is imported where a device is resolved, not by importing the
package: the checker's pool workers (``oracle/check.py``) start as fresh
interpreters that import ``madsim_tpu_torch.oracle.check``, and they stay
numpy-only.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``cuda``, which
    must be available (no silent CPU fallback)."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "madsim_tpu_torch runs on CUDA by default and no GPU is "
                "available; pass device='cpu' to run the plain torch path"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is unavailable")
    return dev
