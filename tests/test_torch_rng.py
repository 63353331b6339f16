"""Port parity: madsim_tpu_torch.engine.rng against jax.random and
madsim_tpu.engine.rng, exactly (value, dtype, shape)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.engine import faults as rfaults
from madsim_tpu.engine import rng as rrng
from madsim_tpu_torch.engine import faults as pfaults
from madsim_tpu_torch.engine import rng as prng

_RS = np.random.RandomState(1234)
SEEDS = np.concatenate([
    np.array([0, 1, -1, 7, 2**31, 2**32 - 1, 2**32, 2**32 + 5, 2**40 + 3,
              -(2**33), 2**63 - 1, -(2**63)], np.int64),
    _RS.randint(-(2**63), 2**63 - 1, size=20, dtype=np.int64),
])


def _key_data(seed):
    return np.asarray(jax.random.key_data(jax.random.key(int(seed))))


def _words(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_seed_key_matches_jax_key_data():
    ref = np.stack([_key_data(s) for s in SEEDS]).astype(np.int64)
    port = prng.seed_key(torch.from_numpy(SEEDS)).numpy()
    assert port.dtype == np.int64
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize(
    "data", [0, 1, 12345, 0x7FFF_FFFF, rfaults.FAULT_STREAM, 2**32 - 1]
)
def test_fold_in_matches_jax(data):
    assert pfaults.FAULT_STREAM == rfaults.FAULT_STREAM
    ref = np.stack([
        np.asarray(jax.random.key_data(jax.random.fold_in(jax.random.key(int(s)), data)))
        for s in SEEDS
    ]).astype(np.int64)
    port = prng.fold_in(prng.seed_key(torch.from_numpy(SEEDS)), data).numpy()
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("n", [1, 15, 21])
def test_bits_matches_jax_partitionable(n):
    ref = np.stack([
        np.asarray(jax.random.bits(jax.random.key(int(s)), (n,), dtype=jnp.uint32))
        for s in SEEDS
    ]).astype(np.int64)
    port = prng.bits(prng.seed_key(torch.from_numpy(SEEDS)), n).numpy()
    np.testing.assert_array_equal(port, ref)


def test_event_bits_matches_reference():
    ctr = _RS.randint(0, 2**31 - 1, size=len(SEEDS)).astype(np.int32)
    ctr[:4] = [0, 1, 2**31 - 1, 600]
    ref = np.stack([
        np.asarray(rrng.event_bits(jax.random.key(int(s)), jnp.int32(c), 15))
        for s, c in zip(SEEDS, ctr)
    ])
    keys = torch.from_numpy(np.stack([_key_data(s) for s in SEEDS]))  # uint32
    port = prng.event_bits(keys, torch.from_numpy(ctr), 15).numpy()
    np.testing.assert_array_equal(port, ref.astype(np.int64))


def test_threefry_matches_reference_restatement():
    k = _RS.randint(0, 2**32, size=(4, 64), dtype=np.uint64).astype(np.uint32)
    r0, r1 = rfaults._threefry2x32(*(jnp.asarray(a) for a in k))
    p0, p1 = prng.threefry2x32(*(_words(a) for a in k))
    np.testing.assert_array_equal(p0.numpy(), np.asarray(r0).astype(np.int64))
    np.testing.assert_array_equal(p1.numpy(), np.asarray(r1).astype(np.int64))


@pytest.mark.parametrize(
    "low,high",
    [
        (50, 101),  # clock jitter
        (0, 5),  # node draw
        (150_000_000, 300_000_000),  # election timeout
        (0, 2**31),  # span exactly 2**31
        (0, 5_000_000_000),  # span > 2**31: the limb path
        (1_000_000_000, 2**47),  # widest exact span
    ],
)
def test_bounded_matches_reference(low, high):
    u = _RS.randint(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    u[:3] = [0, 1, 2**32 - 1]
    ref = np.asarray(rrng.bounded(jnp.asarray(u), low, high))
    port = prng.bounded(_words(u), low, high).numpy()
    assert port.dtype == ref.dtype == np.int64
    np.testing.assert_array_equal(port, ref)


def test_bounded_with_per_seed_bounds():
    u = _RS.randint(0, 2**32, size=256, dtype=np.uint64).astype(np.uint32)
    lo = _RS.randint(0, 10**9, size=256).astype(np.int64)
    hi = lo + _RS.randint(1, 6 * 10**9, size=256).astype(np.int64)
    ref = np.asarray(rrng.bounded(jnp.asarray(u), jnp.asarray(lo), jnp.asarray(hi)))
    port = prng.bounded(_words(u), torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("p", [0.0, 0.01, 0.5, 0.999, 1.0])
def test_coin_and_prob_to_q32_match_reference(p):
    q = rrng.prob_to_q32(p)
    assert prng.prob_to_q32(p) == q
    u = _RS.randint(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    u[:2] = [q & 0xFFFFFFFF, max(q - 1, 0)]
    ref = np.asarray(rrng.coin(jnp.asarray(u), q))
    port = prng.coin(_words(u), q).numpy()
    assert port.dtype == ref.dtype == np.bool_
    np.testing.assert_array_equal(port, ref)
