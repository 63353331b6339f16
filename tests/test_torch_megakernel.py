"""Port parity: the megasweep path (the probe workload, the plain
``run_megasweep_ref`` and ``run_megasweep`` on the CPU), the megasweep
kernel's own per-seed event function and the kernels' shared per-lane
arithmetic.

The reference runs as its own tests run it on the CPU: ``core._drive``
and ``megakernel.run_megasweep(..., interpret=True)``. The headers
``csrc/sim_math.cuh`` (threefry, murmur, mulhi, the clock step) and
``csrc/probe_event.cuh`` (the kernel's ``probe_run``), built by g++ into a
small ctypes library, are held to the port's torch functions, to the
reference kernel's helpers and to the reference's ``_drive``. Exact
equality throughout."""

import ctypes
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.engine import core as rcore
from madsim_tpu.engine import megakernel as rmk
from madsim_tpu.engine.rng import event_bits as r_event_bits
from madsim_tpu.engine.rng import seed_key as r_seed_key
from madsim_tpu_torch.engine import core as pcore
from madsim_tpu_torch.engine import cuda_megasweep, cuda_queue, rng, state_io, tree
from madsim_tpu_torch.engine import megakernel as pmk

import chip_smoke
from _torch_parity import assert_leaves_equal, port_ecfg, ref_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "madsim_tpu_torch", "csrc")

# (steps, seeds, tile, time_limit): the cases of tests/test_megakernel.py
CASES = [(40, 16, 8, 1 << 62), (17, 16, 4, 1 << 62), (60, 8, 8, 120_000_000)]


# the edited probe states of chip_smoke.PROBE_STATES at their shape: payload
# nodes whose ring cell wraps in int32, tied deadlines, empty queues
STATES = [(*chip_smoke.PROBE_STATE_SHAPE, edit) for _, edit in chip_smoke.PROBE_STATES]
STATE_IDS = [name for name, _ in chip_smoke.PROBE_STATES]


def _pair(steps, seeds, time_limit, edit=None):
    """The reference's and the port's initial probe states, their queues
    changed alike by ``edit(time, pay)`` when given."""
    rcfg = rmk.probe_config(max_steps=steps)._replace(time_limit_ns=time_limit)
    r0 = rcore._init(rmk.probe_workload(), rcfg, jnp.arange(seeds, dtype=jnp.int64))
    p0 = pcore.init_sweep(pmk.probe_workload(), port_ecfg(rcfg), np.arange(seeds),
                          device="cpu")
    if edit is not None:
        time = torch.from_numpy(np.array(r0.queue.time))
        pay = torch.from_numpy(np.array(r0.queue.pay))
        edit(time, pay)
        r0 = r0._replace(queue=r0.queue._replace(time=jnp.asarray(time.numpy()),
                                                 pay=jnp.asarray(pay.numpy())))
        p0 = p0._replace(queue=p0.queue._replace(time=time, pay=pay))
    return rcfg, r0, p0


def test_probe_config_and_workload_match_the_reference():
    assert port_ecfg(rmk.probe_config(512)) == pmk.probe_config(512)
    wr, wp = rmk.probe_workload(), pmk.probe_workload()
    for f in ("num_rand", "payload_slots", "max_emits", "cover_bits", "hist_slots",
              "event_mix_kinds"):
        assert getattr(wr, f) == getattr(wp, f), f
    assert pcore.state_bytes_per_seed(wp, pmk.probe_config(512)) == (
        rcore.state_bytes_per_seed(wr, rmk.probe_config(512)))


@pytest.mark.parametrize("steps,seeds,tile,time_limit", CASES,
                         ids=["40x16_tile8", "17x16_tile4", "time_limit"])
def test_probe_path_equals_reference(steps, seeds, tile, time_limit):
    """``core.drive`` and ``run_megasweep_ref``/``run_megasweep`` of the
    port equal the reference's ``_drive`` and its Pallas megakernel in
    interpret mode, on every leaf, dtype and shape."""
    rcfg, r0, p0 = _pair(steps, seeds, time_limit)
    assert_leaves_equal(ref_leaves(r0), state_io.to_numpy_leaves(p0), "init")
    ref = rcore._drive(rmk.probe_workload(), rcfg, r0)
    mega = rmk.run_megasweep(r0, steps=steps, time_limit=time_limit, tile=tile,
                             interpret=True)
    assert_leaves_equal(ref_leaves(ref), ref_leaves(mega), "reference kernel vs drive")
    want = ref_leaves(ref)
    drove = pcore.drive(pmk.probe_workload(), port_ecfg(rcfg), p0)
    assert_leaves_equal(want, state_io.to_numpy_leaves(drove), "drive")
    assert_leaves_equal(want, state_io.to_numpy_leaves(
        pmk.run_megasweep_ref(p0, steps, time_limit)), "run_megasweep_ref")
    before = pmk.run_megasweep.launches
    got = pmk.run_megasweep(p0, steps, time_limit, tile=tile)
    assert pmk.run_megasweep.launches == before  # the plain path launches nothing
    assert_leaves_equal(want, state_io.to_numpy_leaves(got), "run_megasweep")
    if time_limit < 1 << 62:
        assert bool(got.done.any())  # the limit fired for some seed


@pytest.mark.parametrize("steps,seeds,edit", STATES, ids=STATE_IDS)
def test_probe_path_equals_reference_on_edited_states(steps, seeds, edit):
    """The port's ``run_megasweep`` on the CPU equals the reference's
    ``_drive`` and its Pallas kernel in interpret mode on the edited
    states: ring cells reached through an int32 wrap-around, tied
    deadlines and empty queues."""
    rcfg, r0, p0 = _pair(steps, seeds, 1 << 62, edit)
    ref = rcore._drive(rmk.probe_workload(), rcfg, r0)
    mega = rmk.run_megasweep(r0, steps=steps, tile=seeds, interpret=True)
    assert_leaves_equal(ref_leaves(ref), ref_leaves(mega), "reference kernel vs drive")
    got = pmk.run_megasweep(p0, steps, tile=seeds)
    assert_leaves_equal(ref_leaves(ref), state_io.to_numpy_leaves(got), "run_megasweep")


def test_probe_state_carries_across_in_reference_leaf_order():
    """The reference's probe state (``_ProbeW`` leaves included) loads
    into the port and runs on to the reference's result."""
    rcfg, r0, _ = _pair(17, 8, 1 << 62)
    ref = rcore._drive(rmk.probe_workload(), rcfg, r0)
    p0 = state_io.from_numpy_leaves(ref_leaves(r0), pmk.probe_workload(), port_ecfg(rcfg),
                                    device="cpu")
    assert isinstance(p0.wstate, pmk._ProbeW)
    assert_leaves_equal(ref_leaves(r0), state_io.to_numpy_leaves(p0), "loaded")
    got = pmk.run_megasweep(p0, 17, tile=4)
    assert_leaves_equal(ref_leaves(ref), state_io.to_numpy_leaves(got), "after load")


def test_run_megasweep_refuses_what_the_reference_refuses():
    _, r0, p0 = _pair(4, 16, 1 << 62)
    for state, run in ((r0, lambda s, **kw: rmk.run_megasweep(s, 4, interpret=True, **kw)),
                       (p0, lambda s, **kw: pmk.run_megasweep(s, 4, **kw))):
        with pytest.raises(ValueError, match="multiple of tile"):
            run(state, tile=5)
    wide = p0._replace(cover=torch.zeros((16, 1), dtype=torch.uint32))
    with pytest.raises(ValueError, match="coverage"):
        pmk.run_megasweep(wide, 4, tile=8)
    hist = p0._replace(hist_rec=torch.zeros((16, 2, 5), dtype=torch.int32))
    with pytest.raises(ValueError, match="history"):
        pmk.run_megasweep(hist, 4, tile=8)
    with pytest.raises(ValueError, match="device"):
        pmk.run_megasweep(tree.map(lambda a: a.to("meta"), p0), 4, tile=8)


@pytest.fixture(scope="module")
def header_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' shared header for the host")
    out = tmp_path_factory.mktemp("sim_math") / "libsim_math_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(out),
         os.path.join(CSRC, "sim_math_host.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    u32 = ctypes.c_uint32
    lib.madsim_event_words.argtypes = [u32, u32, u32, ctypes.c_int, ctypes.POINTER(u32)]
    lib.madsim_event_words.restype = None
    lib.madsim_murmur_prio.argtypes = [u32, u32]
    lib.madsim_murmur_prio.restype = u32
    lib.madsim_mulhi32.argtypes = [u32, u32]
    lib.madsim_mulhi32.restype = u32
    lib.madsim_clock_step.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, u32]
    lib.madsim_clock_step.restype = ctypes.c_longlong
    lib.madsim_megasweep_host.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_longlong])
    lib.madsim_megasweep_host.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize(
    "steps,seeds,time_limit,edit",
    [(steps, seeds, limit, None) for steps, seeds, _, limit in CASES]
    + [(steps, seeds, 1 << 62, edit) for steps, seeds, edit in STATES],
    ids=["40x16", "17x16", "time_limit"] + STATE_IDS,
)
def test_kernel_event_function_equals_reference(header_lib, steps, seeds, time_limit, edit):
    """The megasweep kernel's own arithmetic (``probe_run`` of
    ``csrc/probe_event.cuh``, built for the host, each seed's slots
    addressed in the planes ``cuda_megasweep.planes`` makes) equals the
    reference's ``_drive`` on every leaf: at the reference test's shapes,
    where payload word 0 puts the ring cell in rows 1, 3 and 4 through an
    int32 wrap-around, where live slots tie at the minimum deadline (the
    lazily drawn tie word) and where queues are empty."""
    rcfg, r0, p0 = _pair(steps, seeds, time_limit, edit)
    want = ref_leaves(rcore._drive(rmk.probe_workload(), rcfg, r0))
    planes = cuda_megasweep.planes(p0)
    rc = header_lib.madsim_megasweep_host(*cuda_megasweep.pointers(planes), seeds,
                                          p0.queue.time.shape[1], steps, time_limit)
    assert rc == 0
    got = cuda_megasweep.to_state(p0, planes)
    assert_leaves_equal(want, state_io.to_numpy_leaves(got), "kernel event function")
    assert_leaves_equal(ref_leaves(r0), state_io.to_numpy_leaves(p0), "the input state")
    if time_limit < 1 << 62:
        assert bool(got.done.any())


@pytest.mark.parametrize("seed", [0, 3, 123456, (1 << 32) + 5, (1 << 40) + 77])
def test_header_event_words_match_both_packages(header_lib, seed):
    key = rng.seed_key(torch.tensor([seed], dtype=torch.int64))
    rkey = r_seed_key(jnp.asarray(seed, jnp.int64))
    kd = jax.random.key_data(rkey).astype(jnp.uint32)
    assert [int(k) for k in key[0]] == [int(k) for k in kd]
    for ctr in (0, 1, 999):
        out = (ctypes.c_uint32 * 15)()
        header_lib.madsim_event_words(int(key[0, 0]), int(key[0, 1]), ctr, 15, out)
        port = rng.event_bits(key, torch.tensor([ctr], dtype=torch.int32), 15)[0]
        ref = r_event_bits(rkey, jnp.asarray(ctr, jnp.int32), 15)
        kernel = rmk._event_words(kd[0].reshape(1, 1), kd[1].reshape(1, 1),
                                  jnp.full((1, 1), ctr, jnp.uint32), 15)[0]
        assert list(out) == port.tolist() == np.asarray(ref).tolist() == (
            np.asarray(kernel).tolist()), (seed, ctr)


def test_header_murmur_mulhi_and_clock_match(header_lib):
    rs = np.random.RandomState(11)
    ties = rs.randint(0, 1 << 32, size=64, dtype=np.uint64)
    prio = cuda_queue.murmur_prio(torch.from_numpy(ties.astype(np.int64)), 64)
    for i, tie in enumerate(ties):
        for slot in (0, 1, 31, 57, 63):
            assert header_lib.madsim_murmur_prio(slot, int(tie)) == int(prio[i, slot])
    xs = rs.randint(0, 1 << 32, size=256, dtype=np.uint64)
    for c in (1, 5, 51, 19_000_001, 0x7FFFFFFF, 0xFFFFFFFF):
        ref = np.asarray(rmk._mulhi32(jnp.asarray(xs, jnp.uint32), c))
        got = [header_lib.madsim_mulhi32(int(x), c) for x in xs]
        assert got == ref.tolist(), c
        if c < 1 << 31:  # engine/rng.bounded's span range on this path
            b = rng.bounded(torch.from_numpy(xs.astype(np.int64)), 0, c)
            assert got == b.tolist(), c
    inv = cuda_queue.INVALID_TIME
    for now, t, found in ((5, 100, 1), (100, 5, 1), (7, inv, 0), (1 << 62, 3, 1)):
        want = (max(now, t) if found else now) + 73
        assert header_lib.madsim_clock_step(now, t, found, 73) == want
