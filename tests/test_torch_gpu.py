"""The pop-min CUDA kernel against its plain version, on the card.

Marked ``gpu``: the kernel has no CPU or interpret mode, so this skips
where no CUDA card is present. This file imports no JAX (the card's
machine has none); run it there with
``python -m pytest tests/test_torch_gpu.py -m gpu -q``."""

import numpy as np
import pytest
import torch

from madsim_tpu_torch.engine import cuda_queue

INV = cuda_queue.INVALID_TIME


def _time_plane(rs, s, q, free_frac, time_hi):
    time = rs.randint(0, time_hi, size=(s, q)).astype(np.int64)
    time[rs.rand(s, q) < free_frac] = INV
    return torch.from_numpy(time)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "free_frac,time_hi,capacity",
    [(0.3, 4, 64), (1.0, 4, 64), (0.0, 10**9, 64), (0.5, 3, 58), (0.2, 2, 200)],
    ids=["ties", "empty", "full", "q58", "q200"],
)
def test_kernel_matches_plain_version_on_the_card(free_frac, time_hi, capacity):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    rs = np.random.RandomState(9)
    time = _time_plane(rs, 16384, capacity, free_frac, time_hi).cuda()
    tie = torch.from_numpy(rs.randint(0, 2**32, size=16384).astype(np.int64)).cuda()
    before = cuda_queue.pop_min_decision.launches
    slot, found = cuda_queue.pop_min_decision(time, tie)
    torch.cuda.synchronize()
    assert cuda_queue.pop_min_decision.launches == before + 1
    ref_slot, ref_found = cuda_queue.pop_min_decision_ref(time, tie)
    assert torch.equal(slot, ref_slot) and torch.equal(found, ref_found)


@pytest.mark.gpu
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    time = torch.zeros((8, 64), dtype=torch.int64, device="cuda")
    tie = torch.zeros((8,), dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError):
        cuda_queue.pop_min_decision(time.to(torch.int32), tie)
    with pytest.raises(ValueError):
        cuda_queue.pop_min_decision(time[:, ::2], tie)
    with pytest.raises(ValueError):
        cuda_queue.pop_min_decision(time, tie[:4])


def _probe_state(num_seeds, steps, time_limit):
    from madsim_tpu_torch.engine import core, megakernel

    wl = megakernel.probe_workload()
    cfg = megakernel.probe_config(steps)._replace(time_limit_ns=time_limit)
    return core.init_sweep(wl, cfg, torch.arange(num_seeds), device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "steps,seeds,tile,time_limit",
    [(40, 16, 8, 1 << 62), (17, 16, 4, 1 << 62), (60, 8, 8, 120_000_000)],
    ids=["40x16_tile8", "17x16_tile4", "time_limit"],
)
def test_megasweep_kernel_matches_plain_version_on_the_card(steps, seeds, tile, time_limit):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    from madsim_tpu_torch.engine import megakernel, state_io

    s0 = _probe_state(seeds, steps, time_limit)
    before = megakernel.run_megasweep.launches
    got = megakernel.run_megasweep(s0, steps, time_limit, tile=tile)
    torch.cuda.synchronize()
    assert megakernel.run_megasweep.launches == before + 1  # one launch per call
    ref = megakernel.run_megasweep_ref(s0, steps, time_limit)
    a, b = state_io.to_numpy_leaves(ref), state_io.to_numpy_leaves(got)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert (x == y).all(), f"leaf {i} differs"
    if time_limit < 1 << 62:
        assert bool(got.done.any())  # the limit fired for some seed


@pytest.mark.gpu
def test_megasweep_wrapper_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from madsim_tpu_torch.engine import core, megakernel
    from madsim_tpu_torch.models import raft

    s0 = _probe_state(16, 4, 1 << 62)
    with pytest.raises(ValueError, match="multiple of tile"):
        megakernel.run_megasweep(s0, 4, tile=5)
    wide = s0._replace(cover=torch.zeros((16, 1), dtype=torch.uint32, device="cuda"))
    with pytest.raises(ValueError, match="coverage"):
        megakernel.run_megasweep(wide, 4, tile=8)
    cfg = raft.RaftConfig(num_nodes=3)
    other = core.init_sweep(raft.workload(cfg), raft.engine_config(cfg), torch.arange(8),
                            device="cuda")
    with pytest.raises(ValueError):
        megakernel.run_megasweep(other, 4, tile=8)
