"""Port parity: the port's entry module (``madsim_tpu_torch.entry``) —
the counterpart of ``tests/test_entry.py`` for ``__graft_entry__``.

``entry(device="cpu")``'s one step equals the reference ``entry()``'s
jitted step on every leaf; ``dryrun_multichip(8, device="cpu")`` spawns
its own 8-rank gloo world and passes every check it makes (under
``slow``: ``dryrun_multichip(2, device="cpu")`` runs in tier-1 as part of
``chip_smoke.py`` phase 15's rehearsal, ``tests/test_torch_chip_smoke_mesh.py``).
Also the world's and the mesh's explicit backend rules: no NCCL on the
CPU, no silent one-rank fallback."""

import os
import sys

import jax
import pytest
import torch

from madsim_tpu_torch import entry as pentry
from madsim_tpu_torch.parallel import World, seed_mesh

from _torch_parity import assert_leaves_equal, ref_leaves

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402


def test_entry_one_step_equals_reference():
    rfn, (rstate,) = graft.entry()
    pfn, (pstate,) = pentry.entry(device="cpu")
    assert_leaves_equal(ref_leaves(rstate), [a.numpy() for a in _leaves(pstate)], "init")
    rout, pout = jax.jit(rfn)(rstate), pfn(pstate)
    assert_leaves_equal(ref_leaves(rout), [a.numpy() for a in _leaves(pout)], "one step")
    assert int(pout.done.sum()) < pout.done.shape[0]


def _leaves(state):
    from madsim_tpu_torch.engine import tree

    return tree.leaves(state)


def test_entry_points_default_to_cuda_and_refuse_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None legitimately runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        pentry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        seed_mesh()
    with pytest.raises(RuntimeError, match="card"):
        World(1, device="cuda")


def test_world_defaults_to_cuda_and_refuses_without_it():
    """``World(n)`` with no device means CUDA, like every other entry
    point: without a card it raises instead of spawning CPU ranks."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None legitimately runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        World(1)


def test_world_backend_is_explicit():
    """No NCCL on the CPU; outside a process group the mesh is the
    one-rank mesh, whose collectives are no-ops."""
    with pytest.raises(ValueError, match="gloo"):
        World(2, device="cpu", backend="nccl")
    mesh = seed_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.backend) == (None, 0, 1, "")


@pytest.mark.slow
def test_dryrun_multichip_8():
    out = pentry.dryrun_multichip(8, device="cpu", curve_seeds=512, curve_chunk=64,
                                  curve_warm=0)
    assert out["counts"] == (1, 2, 4, 8)
