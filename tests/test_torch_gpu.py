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
