# The benchmark's plain reference: a frozen copy of madsim_tpu_torch/engine/ops.py, run on the CPU.
# A change to the program's semantics reaches it only through a change to the benchmark.
"""Batched indexing primitives (counterpart of ``madsim_tpu/engine/ops.py``).

Every array carries a leading seed axis ``S`` and every index is a
per-seed ``[S]`` tensor. The reference builds one-hot masks because TPU
gathers are slow; on the GPU a gather is fine, so reads are indexed
loads. The semantics are the reference's exactly, including its
out-of-range rule: an index outside the axis reads 0 (``False`` for bool)
and writes nothing.
"""

from __future__ import annotations

import torch

# torch's uint32 is a storage type: CUDA implements casts to and from it
# but no where, indexing or bitwise kernels. uint32 planes are therefore
# read and written through int64 (exact for 32-bit words) on every device,
# so the CPU tests run the same code path as the card.
U32 = torch.uint32


def _is_u32(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dtype == U32


def wide(x):
    """``x`` in a dtype every kernel supports (uint32 -> int64)."""
    return x.to(torch.int64) if _is_u32(x) else x


def where(mask: torch.Tensor, a, b) -> torch.Tensor:
    """``torch.where`` that also takes uint32 operands (kept uint32).
    Either operand may be a python scalar: it is passed through as one
    (no host-to-device copy, which would synchronise the stream)."""
    if _is_u32(a) or _is_u32(b):
        return torch.where(mask, wide(a), wide(b)).to(U32)
    return torch.where(mask, a, b)


def _lanes(arr: torch.Tensor) -> torch.Tensor:
    return torch.arange(arr.shape[0], device=arr.device)


def _zero_like_elem(arr: torch.Tensor):
    return False if arr.dtype == torch.bool else 0


def expand(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """A leading-axes mask (or per-seed value) broadcastable against an
    ``ndim``-dim array."""
    return mask.reshape(mask.shape + (1,) * (ndim - mask.ndim))


def _per_seed_val(val, arr: torch.Tensor) -> torch.Tensor:
    """``val`` shaped to broadcast against ``arr [S, n, ...]`` at the
    written position: a python scalar, a per-seed ``[S]`` value, or a
    per-seed row ``[S, *arr.shape[2:]]``."""
    if not isinstance(val, torch.Tensor):
        # a python scalar broadcasts as itself (cast like the reference's
        # jnp.asarray(val, arr.dtype), so 1 written to a bool plane is True)
        return bool(val) if arr.dtype == torch.bool else int(val)
    val = val.to(arr.dtype)
    if val.ndim == 1:
        return val.reshape((-1,) + (1,) * (arr.ndim - 1))
    if val.ndim > 1:
        return val.unsqueeze(1)
    return val


def onehot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """bool[S, n] with True at ``idx[s]`` (out of range selects nothing)."""
    idx = idx.to(torch.int64)
    return torch.arange(n, device=idx.device) == idx[..., None]


def get1(arr: torch.Tensor, idx) -> torch.Tensor:
    """``arr[s, idx[s]]`` along axis 1 (works for rows too)."""
    idx = idx.to(torch.int64)
    n = arr.shape[1]
    ok = (idx >= 0) & (idx < n)
    v = wide(arr)[_lanes(arr), idx.clamp(0, n - 1)]
    return torch.where(expand(ok, v.ndim), v, _zero_like_elem(arr)).to(arr.dtype)


def set1(arr: torch.Tensor, idx, val, enable=True) -> torch.Tensor:
    """``arr[s, idx[s]] = val[s]`` where ``enable[s]`` (axis 1; ``val`` is
    a scalar, a per-seed ``[S]`` value or a per-seed row)."""
    mask = onehot(idx.to(torch.int64), arr.shape[1])
    if not (isinstance(enable, bool) and enable):
        mask = mask & enable[:, None]
    return where(expand(mask, arr.ndim), _per_seed_val(val, arr), arr)


def geti(arr: torch.Tensor, idxs) -> torch.Tensor:
    """``arr[s, idxs[s, k]]``: gather a vector of indices per seed from
    ``arr [S, n]``; returns ``idxs.shape``."""
    idxs = idxs.to(torch.int64)
    n = arr.shape[1]
    ok = (idxs >= 0) & (idxs < n)
    v = torch.gather(wide(arr), 1, idxs.clamp(0, n - 1))
    return torch.where(ok, v, _zero_like_elem(arr)).to(arr.dtype)


def get2(arr: torch.Tensor, i, j) -> torch.Tensor:
    """``arr[s, i[s], j[s]]`` from ``arr [S, n, m]``."""
    i = i.to(torch.int64)
    j = j.to(torch.int64)
    n, m = arr.shape[1], arr.shape[2]
    ok = (i >= 0) & (i < n) & (j >= 0) & (j < m)
    v = wide(arr)[_lanes(arr), i.clamp(0, n - 1), j.clamp(0, m - 1)]
    return torch.where(ok, v, _zero_like_elem(arr)).to(arr.dtype)


def set2(arr: torch.Tensor, i, j, val, enable=True) -> torch.Tensor:
    """``arr[s, i[s], j[s]] = val[s]`` where ``enable[s]``."""
    mask = onehot(i.to(torch.int64), arr.shape[1])[:, :, None] & onehot(
        j.to(torch.int64), arr.shape[2]
    )[:, None, :]
    if not (isinstance(enable, bool) and enable):
        mask = mask & enable[:, None, None]
    return where(mask, _per_seed_val(val, arr), arr)
