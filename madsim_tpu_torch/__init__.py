"""PyTorch/CUDA port of the batched simulation engine (``madsim_tpu``).

The JAX package ``madsim_tpu`` is the reference: every function here is
held to it bit for bit (the engine is integer-only, so parity is exact).
This package imports ``torch`` and numpy only — never ``jax`` and nothing
of ``madsim_tpu``.

Layout mirrors the reference: ``engine/`` (rng, ops, queue, core, net,
faults, the pop-min CUDA kernel), ``models/`` (raft), ``oracle/`` (the
history code constants raft records with).

Every entry point takes ``device=None``; ``None`` means CUDA and raises
when no GPU is present — it never falls back to the CPU. Pass
``device="cpu"`` explicitly to run the plain torch path on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``cuda``, which
    must be available (no silent CPU fallback)."""
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
