"""The pop-min and megasweep CUDA kernels against their plain versions,
on the card.

Marked ``gpu``: the kernels have no CPU or interpret mode, so these skip
where no CUDA card is present. This file imports no JAX (the card's
machine has none); run it there with
``python -m pytest tests/test_torch_gpu.py -m gpu -q``."""

import numpy as np
import pytest
import torch

import chip_smoke
from madsim_tpu_torch.engine import cuda_queue

INV = cuda_queue.INVALID_TIME


def _time_plane(rs, s, q, free_frac, time_hi):
    time = rs.randint(0, time_hi, size=(s, q)).astype(np.int64)
    time[rs.rand(s, q) < free_frac] = INV
    return torch.from_numpy(time)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "free_frac,time_hi,capacity,offset",
    [(0.3, 4, 64, 0), (1.0, 4, 64, 0), (0.0, 10**9, 64, 0), (0.5, 3, 58, 0),
     (0.2, 2, 200, 0), (0.4, 3, 37, 0), (1.0, 4, 37, 0), (0.3, 4, 64, 1)],
    ids=["ties", "empty", "full", "q58", "q200", "q37_odd", "q37_odd_empty",
         "q64_unaligned"],
)
def test_kernel_matches_plain_version_on_the_card(free_frac, time_hi, capacity, offset):
    """Q = 64 and 58 take the kernel's 16-byte loads; an odd Q, and a
    plane that starts 8 bytes past a 16-byte boundary, its 8-byte loads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    rs = np.random.RandomState(9)
    plane = _time_plane(rs, 16384, capacity, free_frac, time_hi).cuda()
    # the same values, `offset` int64 words into a fresh allocation
    time = torch.empty(plane.numel() + offset, dtype=torch.int64, device="cuda")
    time = time[offset:].view(plane.shape)
    time.copy_(plane)
    assert time.is_contiguous() and time.data_ptr() % 16 == 8 * offset
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
@pytest.mark.parametrize("name,edit", chip_smoke.PROBE_STATES,
                         ids=[name for name, _ in chip_smoke.PROBE_STATES])
def test_megasweep_kernel_matches_plain_version_on_edited_states(name, edit):
    """Ring cells reached through an int32 wrap-around of payload word 0,
    tied deadlines (the kernel's lazily drawn tie word) and empty queues:
    kernel == plain on every leaf, one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    from madsim_tpu_torch.engine import megakernel, state_io

    steps, seeds = chip_smoke.PROBE_STATE_SHAPE
    s0 = chip_smoke.probe_state(torch.device("cuda"), seeds, steps, edit=edit)
    before = megakernel.run_megasweep.launches
    got = megakernel.run_megasweep(s0, steps, tile=seeds)
    torch.cuda.synchronize()
    assert megakernel.run_megasweep.launches == before + 1
    ref = megakernel.run_megasweep_ref(s0, steps)
    assert state_io.first_difference(ref, got) is None, name


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
