"""``chip_smoke.py`` phase 21 rehearsed on the CPU at the rehearsal size
of its golden: ``sweep_million`` of 24 seeds in chunks of 16 with a
checkpoint directory, in this process (its chunk summaries and line equal
to the JAX package's run of ``scripts/sweep_million.py``, 0 kernel builds
or loads in the timed region) and again as a fresh process that loads
both chunks and computes none; then the determinism gate's dump leg in
two fresh processes, each array equal to the JAX-made dump. No kernel
launches on the CPU."""

import torch

import chip_smoke


def test_scripts_phase_on_the_plain_path():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # an eager step is hundreds of small ops
    try:
        out = chip_smoke.phase_scripts(torch.device("cpu"),
                                       sweep=chip_smoke.SCRIPT_SWEEP_RUNS[1])
    finally:
        torch.set_num_threads(threads)
    assert out["launches"] == 0 and out["a"]["steps"] > 0
    assert out["a"]["first"]["chunks_computed"] == 2
    assert out["a"]["resumed"]["chunks_loaded_from_checkpoint"] == 2
    assert out["b"]["same_archive"]  # the port's archive is the reference's, byte for byte
    assert all(d["engine_steps"] > 0 and d["pop_min_launches"] == 0
               for d in out["b"]["processes"])
