"""The pop-min and megasweep CUDA kernels against their plain versions,
and the checked sweep's torch programs (screens, canonical decode), the
sharded sweep and the steered campaign against their CPU runs, on the
card.

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
     (0.2, 2, 200, 0), (0.4, 3, 37, 0), (1.0, 4, 37, 0), (0.3, 4, 64, 1),
     (0.3, 4, 48, 0), (1.0, 4, 48, 0), (0.0, 3, 48, 0), (0.3, 4, 48, 1)],
    ids=["ties", "empty", "full", "q58", "q200", "q37_odd", "q37_odd_empty",
         "q64_unaligned", "q48_ties", "q48_empty", "q48_full_ties", "q48_unaligned"],
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


@pytest.mark.gpu
def test_pop_min_at_the_etcd_width_on_real_queues():
    """Phase 9's queues (48 slots) after 100 etcd events: kernel == plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    for name, time, tie in chip_smoke.kernel_cases(torch.device("cuda"), 4096, etcd_queue=True):
        assert time.shape[1] == 48
        slot, found = cuda_queue.pop_min_decision(time, tie)
        ref_slot, ref_found = cuda_queue.pop_min_decision_ref(time, tie)
        assert torch.equal(slot, ref_slot) and torch.equal(found, ref_found), name


@pytest.mark.gpu
@pytest.mark.parametrize("stale", [False, True], ids=["clean", "stale"])
def test_screen_and_canon_sweep_on_the_card_equal_the_cpu(stale):
    """``screen_sweep`` and ``canon_sweep`` of a finished etcd chunk on the
    card equal the same functions on a CPU copy (dtypes included)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from madsim_tpu_torch.engine import core, tree
    from madsim_tpu_torch.models import etcd
    from madsim_tpu_torch.oracle import history, screen

    wl, ecfg = chip_smoke.etcd_path(stale)
    final = core.run_sweep(wl, ecfg, torch.arange(2048), device="cuda")
    copy = tree.map(lambda a: a.cpu(), final)
    spec = etcd.history_spec()
    got, want = screen.screen_sweep(final, spec, block=512), screen.screen_sweep(copy, spec)
    assert got.is_cuda and torch.equal(got.cpu(), want)
    assert bool(want.any()) == stale
    for a, b in zip(history.canon_sweep(final, block=512), history.canon_sweep(copy)):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_screen_history_runs_on_the_card(monkeypatch):
    """One lane's rows, as tensors on the card or as numpy with the
    default device, are screened on the card, to the CPU's verdict."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from madsim_tpu_torch.engine import core
    from madsim_tpu_torch.models import etcd
    from madsim_tpu_torch.oracle import screen

    wl, ecfg = chip_smoke.etcd_path(stale=True)
    final = core.run_sweep(wl, ecfg, torch.arange(64), device="cuda")
    spec = etcd.history_spec()
    seen = []
    kv = screen._SCREENS["kv"]

    def spy(rec, t, n):
        seen.append((rec.device.type, t.device.type, n.device.type))
        return kv(rec, t, n)

    verdicts = set()
    for lane in range(64):
        rec, t, n = final.hist_rec[lane], final.hist_t[lane], int(final.hist_len[lane])
        want = screen.screen_history(rec.cpu(), t.cpu(), n, spec)
        monkeypatch.setitem(screen._SCREENS, "kv", spy)
        assert screen.screen_history(rec, t, n, spec) == want
        assert screen.screen_history(rec.cpu().numpy(), t.cpu().numpy(), n, spec) == want
        monkeypatch.setitem(screen._SCREENS, "kv", kv)
        verdicts.add(want)
        assert seen == [("cuda",) * 3] * 2
        seen.clear()
    assert True in verdicts


@pytest.mark.gpu
def test_host_phase_gathers_sparse_suspects_on_the_card():
    """A few suspect lanes (under a quarter of the chunk) are gathered on
    the card before the copy: both decode routes give the CPU's report."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from madsim_tpu_torch.engine import core, tree
    from madsim_tpu_torch.models import etcd
    from madsim_tpu_torch.oracle import history, screen

    wl, ecfg = chip_smoke.etcd_path(stale=True)
    final = core.run_sweep(wl, ecfg, torch.arange(256), device="cuda")
    copy = tree.map(lambda a: a.cpu(), final)
    lanes = [3, 17, 40, 41, 200]
    assert [tuple(h) for h in history.decode_lanes(final, lanes)] == [
        tuple(h) for h in history.decode_lanes(copy, lanes)]
    suspect = np.zeros(256, bool)
    suspect[lanes] = True
    spec = etcd.history_spec()
    reports = [
        screen.history_host_work(spec, device_decode=decode)(
            state, lo=0, n=256, seeds=None, suspect=suspect, summary={})
        for state in (final, copy) for decode in (True, False)
    ]
    assert all(r == reports[0] for r in reports) and reports[0]["hist_suspects"] == 5


def _steps_equal_on_both(wl, ecfg, seeds, steps):
    """``steps`` events of ``seeds`` on the card and on the CPU: every
    leaf equal after each of them."""
    from madsim_tpu_torch.engine import core, state_io

    gpu = core.init_sweep(wl, ecfg, seeds, device="cuda")
    cpu = core.init_sweep(wl, ecfg, seeds, device="cpu")
    for i in range(steps):
        gpu = core.step_batch(wl, ecfg, gpu, device="cuda")
        cpu = core.step_batch(wl, ecfg, cpu, device="cpu")
        assert state_io.first_difference(gpu, cpu) is None, f"step {i + 1}"
    return gpu


@pytest.mark.gpu
@pytest.mark.parametrize("bug", [False, True], ids=["clean", "bug"])
def test_kafka_and_s3_steps_on_the_card_equal_the_cpu(bug):
    """Phases 10-11's models: 40 ``step_batch`` events of 512 seeds on the
    card equal the CPU after every event (pop_min launched each time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for path in (chip_smoke.kafka_path(bug), chip_smoke.s3_path(bug),
                 chip_smoke.kafka_checked_path(bug)):
        before = cuda_queue.pop_min_decision.launches
        _steps_equal_on_both(*path, torch.arange(512), 40)
        assert cuda_queue.pop_min_decision.launches == before + 40


@pytest.mark.gpu
def test_stream_round_on_the_card_equals_the_cpu():
    """One stream round and one row refill of phase 13's config on the
    card equal the CPU's, lane for lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from madsim_tpu_torch.engine import core, state_io, stream

    wl, ecfg = chip_smoke.stream_path()
    budget = torch.full((256,), 150, dtype=torch.int32)
    budget[::3] = 40
    out = []
    for dev in ("cuda", "cpu"):
        state = core.init_sweep(wl, ecfg, torch.arange(256), device=dev)
        state = stream._round(wl, ecfg, 96, state, budget.to(dev), stop_live=200)
        lanes = torch.arange(0, 256, 3).numpy()
        state = stream._refill_rows(wl, ecfg, state, lanes, lanes + 1000)
        out.append(state)
    assert state_io.first_difference(*out) is None
    # the round leaves at the reference's step: the 86 lanes of budget 40
    # retire at step 40 and the live count falls to 170 <= 200 there
    assert int(out[0].ctr.min()) == 0 and int(out[0].ctr.max()) == 40


@pytest.mark.gpu
def test_count_compiles_counts_a_kernel_load_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from madsim_tpu_torch.engine import compiles, cuda_build

    cuda_queue.build()
    cuda_build._LIBS.pop("pop_min")
    with compiles.count_compiles() as c:
        cuda_queue.build()
    assert c.count >= 1 and ("load", "pop_min") in c.events
    with compiles.count_compiles() as c:
        cuda_queue.build()
    assert c.count == 0


@pytest.mark.gpu
@pytest.mark.parametrize("ranks", [1, 2])
def test_sharded_sweep_on_the_card_equals_the_cpu(ranks):
    """``run_sweep_sharded`` on ranks on the card (one rank: NCCL; two
    sharing a card: gloo) equals the CPU port's unsharded sweep on every
    leaf, with every step through the pop-min kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import _torch_mesh_jobs as jobs
    from madsim_tpu_torch.engine import core, tree
    from madsim_tpu_torch.parallel import World

    with World(ranks, device="cuda") as world:
        assert world.backend == ("nccl" if ranks <= torch.cuda.device_count() else "gloo")
        out = world.run(jobs.counted_sweep_leaves, "etcd_stale", 64)
    wl, ecfg, _ = jobs.port_case("etcd_stale")
    want = [a.numpy() for a in tree.leaves(core.run_sweep(wl, ecfg, np.arange(64), device="cpu"))]
    for leaves, calls, launches in out:
        assert calls > 0 and launches == calls
        assert len(leaves) == len(want)
        for got, ref in zip(leaves, want):
            assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.gpu
def test_steered_campaign_on_the_card_equals_the_cpu(tmp_path):
    """``run_steered`` of the raft steer gate at the rehearsal size of
    ``chip_smoke.py`` phase 16 on the card writes the CPU run's report and
    decision trace bytes; its triage replays run on the card, every
    engine step through the pop-min kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from madsim_tpu_torch import explore

    target, base = explore.steer_gate(smoke=True)
    ccfg, scfg = chip_smoke.steer_configs(explore, chip_smoke.STEER_RUNS[1])
    blobs = {}
    for device in ("cpu", "cuda"):
        rp, tp = str(tmp_path / f"{device}.jsonl"), str(tmp_path / f"{device}.trace")
        run = chip_smoke.engine_steps_run(torch.device(device), lambda: explore.run_steered(
            target, base, ccfg, scfg, report_path=rp, trace_path=tp, device=device))
        blobs[device] = (open(rp, "rb").read(), open(tp, "rb").read())
        if device == "cuda":
            assert run["replay_steps"] > 0 and run["launches"] == run["calls"] + run["replay_steps"]
    assert blobs["cuda"] == blobs["cpu"]


@pytest.mark.gpu
def test_a_driver_runs_on_the_card_by_default():
    """``python -m madsim_tpu_torch.scripts.sweep_million`` with no
    ``--device`` runs on CUDA: its line names the backend ``cuda``, and a
    ragged tail (16 + 8 seeds) gives the CPU run's totals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=chip_smoke.HERE, MADSIM_SWEEP_CHUNK="16",
               MADSIM_HB_SECONDS="0")
    lines = {}
    for extra in ([], ["--device", "cpu"]):
        proc = subprocess.run(
            [sys.executable, "-m", "madsim_tpu_torch.scripts.sweep_million", "24", *extra],
            cwd=chip_smoke.HERE, env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        lines[bool(extra)] = json.loads(proc.stdout.splitlines()[-1])
    card, cpu = lines[False], lines[True]
    assert card["backend"] == "cuda" and cpu["backend"] == "cpu"
    assert card["compiles_in_timed_region"] == 0
    for key in ("violations", "elections_total", "chunks_computed"):
        assert card[key] == cpu[key]
