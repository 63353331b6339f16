# The benchmark's plain reference: a frozen copy of madsim_tpu_torch/engine/rng.py, run on the CPU.
# A change to the program's semantics reaches it only through a change to the benchmark.
"""Counter-based randomness (counterpart of ``madsim_tpu/engine/rng.py``).

Every draw is threefry-2x32 keyed exactly as the reference keys it with
JAX's partitionable threefry scheme, so a seed consumes bit-identical
randomness on either package and either device:

- ``seed_key(seed)``: ``jax.random.key(int64 seed)`` — the words
  ``(seed >> 32 logical, seed & 0xFFFFFFFF)``;
- ``fold_in(key, d)``: ``threefry(key, (0, d))`` for a 32-bit ``d``;
- ``bits(key, n)``: word ``i`` is ``o0 ^ o1`` of
  ``threefry(key, (i >> 32, i & 0xFFFFFFFF))``.

torch has no usable uint32 arithmetic, so 32-bit words travel in int64
tensors holding values in ``[0, 2**32)`` and every add, multiply and
shift is masked back to 32 bits. Keys are ``[..., 2]`` tensors of those
words (the reference's ``key_data``). No ``torch.Generator`` is used
anywhere: replay is the product.
"""

from __future__ import annotations

import torch

UINT32_SPAN = 1 << 32
M32 = 0xFFFFFFFF

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for 32-bit words ``x`` and a 32-bit constant,
    in two half-width products so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & M32) | (v >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on 32-bit words carried in int64,
    bit-identical to JAX's ``threefry2x32`` (and to the reference's
    ``faults._threefry2x32``). Arguments broadcast."""
    ks2 = k0 ^ k1 ^ 0x1BD11BDA
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    ks = (k1, ks2, k0)
    for i in range(5):
        for j in range(4):
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, _ROT[(i % 2) * 4 + j]) ^ x0
        x0 = (x0 + ks[i % 3]) & M32
        x1 = (x1 + ks[(i + 1) % 3] + (i + 1)) & M32
    return x0, x1


def seed_key(seed: torch.Tensor) -> torch.Tensor:
    """Per-seed base key words ``[..., 2]`` (int64 words) of an int64 seed
    — ``jax.random.key_data(jax.random.key(seed))``."""
    seed = seed.to(torch.int64)
    hi = (seed >> 32) & M32  # logical shift of the two's-complement bits
    lo = seed & M32
    return torch.stack([hi, lo], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for 32-bit ``data`` (a python int
    or an int tensor broadcasting against ``key[..., 0]``)."""
    k0, k1 = key[..., 0], key[..., 1]
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64) & M32
        zero = torch.zeros_like(d)
    else:
        d = torch.full_like(k0, int(data) & M32)
        zero = torch.zeros_like(k0)
    o0, o1 = threefry2x32(k0, k1, zero, d)
    return torch.stack([o0, o1], dim=-1)


def bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per key: ``[..., n]`` words."""
    k0 = key[..., 0:1]
    k1 = key[..., 1:2]
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(k0, k1, torch.zeros_like(idx), idx)
    return o0 ^ o1


def event_bits(key: torch.Tensor, ctr: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` draws for event number ``ctr`` of each seed: ``[S, n]`` words
    from ``key [S, 2]`` (uint32 or int64 words) and ``ctr [S]``."""
    return bits(fold_in(key.to(torch.int64), ctr), n)


def bounded(u32: torch.Tensor, low, high) -> torch.Tensor:
    """Map a 32-bit draw to an int64 in ``[low, high)`` — the reference's
    two-limb multiply-shift, exact for spans up to 2**47."""
    span = high - low  # python ints or int64 tensors, never copied to the device
    u = u32.to(torch.int64)
    hi = u >> 16
    lo = u & 0xFFFF
    carry = (lo * span) >> 16
    return low + ((hi * span + carry) >> 16)


def coin(u32: torch.Tensor, prob_q32) -> torch.Tensor:
    """Bernoulli: the 32-bit draw against a Q0.32 probability (both as
    unsigned 32-bit values)."""
    p = prob_q32.to(torch.int64) if isinstance(prob_q32, torch.Tensor) else prob_q32
    return (u32.to(torch.int64) & M32) < (p & M32)


def prob_to_q32(p: float) -> int:
    """Host-side: a float probability as Q0.32 fixed point."""
    return min(UINT32_SPAN - 1, max(0, int(round(p * UINT32_SPAN))))
