"""The pop-min decision: a hand-written CUDA kernel and its plain version
(counterpart of ``madsim_tpu/engine/pallas_queue.py``).

``pop_min_decision(time, tie)`` returns ``(slot int32[S], found bool[S])``
— the slot ``queue.pop_min`` removes for each seed. On a CUDA tensor it
launches ``csrc/pop_min.cu`` (built for ``sm_90a`` with ``nvcc`` at first
use by ``cuda_build``, bound through a plain C interface with ``ctypes``)
or raises; on a CPU tensor it runs the plain torch version
``pop_min_decision_ref``. There is no fallback from one to the
other: a CUDA tensor never takes the plain path.

``pop_min_decision.launches`` counts kernels that ran (the plain path
does not count), so a run can show that the main path went through the
kernel. A launch into a CUDA graph being captured runs nothing: it is
counted apart, in ``pop_min_decision.captured``, and ``core.drive``'s
step graph adds the launches its capture took in to ``launches`` each
time it replays.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_build
from .rng import M32, mul32

INVALID_TIME = (1 << 63) - 1
HASH_MULT = 2654435761  # Knuth multiplicative hash constant


def murmur_prio(tie: torch.Tensor, capacity: int) -> torch.Tensor:
    """``[S, Q]`` tie-break priorities ``fmix32(slot * 2654435761 ^ tie)``
    as 32-bit words in int64 — the reference's hash, verbatim."""
    iota = torch.arange(capacity, dtype=torch.int64, device=tie.device)
    x = mul32(iota, HASH_MULT)[None, :] ^ (tie.to(torch.int64) & M32)[:, None]
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def pop_min_decision_ref(
    time: torch.Tensor, tie: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel: minimum deadline, then the
    minimal priority among the slots at that deadline, then the first
    such slot (``argmin`` returns the first minimum)."""
    prio = murmur_prio(tie, time.shape[1])
    t = time.min(dim=1).values
    cand = time == t[:, None]
    slot = torch.where(cand, prio, 1 << 33).argmin(dim=1).to(torch.int32)
    return slot, t != INVALID_TIME


def build() -> ctypes.CDLL:
    """Compile ``csrc/pop_min.cu`` (unless an identical build exists) and
    load it; ``cuda_build.LOGS["pop_min"]`` keeps the compiler's output."""
    return cuda_build.build(
        "pop_min", "madsim_pop_min",
        [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )


def _launch(time: torch.Tensor, tie: torch.Tensor):
    if time.dtype != torch.int64 or time.ndim != 2 or not time.is_contiguous():
        raise ValueError(
            f"pop_min kernel takes a contiguous int64[S, Q] time plane, got "
            f"{time.dtype} {tuple(time.shape)} contiguous={time.is_contiguous()}"
        )
    s, q = time.shape
    if q < 1 or q >= 1 << 31 or s >= 1 << 31:
        raise ValueError(f"pop_min kernel: unsupported shape {(s, q)}")
    if tie.shape != (s,) or tie.device != time.device:
        raise ValueError(
            f"tie must be [S]={s} on {time.device}, got {tuple(tie.shape)} "
            f"on {tie.device}"
        )
    if tie.dtype not in (torch.int64, torch.int32, torch.uint32):
        raise ValueError(f"tie must hold 32-bit words, got {tie.dtype}")
    tie32 = tie.to(torch.int32).contiguous()  # the low word, bit for bit
    slot = torch.empty((s,), dtype=torch.int32, device=time.device)
    found = torch.empty((s,), dtype=torch.bool, device=time.device)
    lib = build()
    rc = lib.madsim_pop_min(
        time.data_ptr(), tie32.data_ptr(), slot.data_ptr(), found.data_ptr(),
        s, q, torch.cuda.current_stream(time.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"pop_min kernel launch failed: CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        pop_min_decision.captured += 1
    else:
        pop_min_decision.launches += 1
    return slot, found


def pop_min_decision(
    time: torch.Tensor, tie: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(slot int32[S], found bool[S])`` of each seed's pop: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if time.device.type == "cuda":
        return _launch(time, tie)
    if time.device.type == "cpu":
        return pop_min_decision_ref(time, tie)
    raise ValueError(f"pop_min_decision: unsupported device {time.device}")


pop_min_decision.launches = 0
pop_min_decision.captured = 0
