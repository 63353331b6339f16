"""Port parity: the compiled host core (``madsim_tpu_torch/native``) — the
port of the reference's ``tests/test_native.py``.

The port builds ``simcore.cpp`` (ctypes) and ``simloop.c`` (a CPython
extension) at first use into ``madsim_tpu_torch/_build/native/`` and
loads ``_simloop`` under its own dotted name. Each reference test runs
against the port: the C++ timer heap and ready queue against the
reference's, the native threefry against JAX and against the port's own
``engine.rng``, and the compiled core's schedule transparency — byte-equal
results with the core on, off (``MADSIM_NO_NATIVE=1``) and on the older
ctypes backend (``MADSIM_NATIVE=1``), each in a fresh interpreter, since
the core is bound when ``time``, ``task`` and ``futures`` load. Paths are
derived from this file.
"""

import functools
import gc
import json
import os
import subprocess
import sys
import threading

import pytest

import madsim_tpu as R
import madsim_tpu_torch as P
from madsim_tpu import native as rnative
from madsim_tpu_torch import native

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
BUILD = os.path.join(REPO, "madsim_tpu_torch", "_build", "native")

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"g++ unavailable or native build failed: {native.build_error()}"
)


def test_timer_heap_min_order_with_fifo_ties():
    out = []
    for mod in (native, rnative):
        h = mod.TimerHeap()
        for deadline, id in ((50, 1), (10, 2), (10, 3), (30, 4)):  # 10: FIFO by insertion
            h.push(deadline, id)
        assert len(h) == 4 and h.peek() == (10, 2)
        out.append([h.pop() for _ in range(5)])
    assert out[0] == out[1] == [(10, 2), (10, 3), (30, 4), (50, 1), None]


def test_ready_queue_swap_remove():
    out = []
    for mod in (native, rnative):
        q = mod.ReadyQueue()
        for i in range(5):
            q.push(100 + i)
        # swap-remove: removing idx 1 moves the last element into it
        got = [q.swap_remove(1), len(q), q.swap_remove(1)]
        got.append(sorted(q.swap_remove(0) for _ in range(3)))
        out.append(got)
    assert out[0] == out[1] == [101, 4, 104, [100, 102, 103]]


def test_threefry_matches_jax_and_the_ports_rng():
    """The native threefry reproduces the exact (seed, ctr) -> draws stream
    of ``engine/rng.py``'s ``event_bits`` — JAX's fold_in + partitionable
    random bits, and the port's torch version — in one native batch."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from madsim_tpu_torch.engine import rng

    for seed in (0, 1, 42, 2**31):
        key = jax.random.key(seed)
        kdata = [int(w) for w in np.asarray(jax.random.key_data(key), dtype=np.uint32)]
        pkey = rng.seed_key(torch.tensor([seed], dtype=torch.int64))
        assert pkey[0].tolist() == kdata
        for ctr in (0, 1, 7, 123456):
            expect = [int(x) for x in np.asarray(
                jax.random.bits(jax.random.fold_in(key, ctr), (5,), dtype=jnp.uint32))]
            k2 = native.fold_in(kdata[0], kdata[1], ctr)
            assert native.random_bits(k2[0], k2[1], 5) == expect, (seed, ctr)
            assert rnative.random_bits(*rnative.fold_in(kdata[0], kdata[1], ctr), 5) == expect
            port = rng.event_bits(pkey, torch.tensor([ctr]), 5)[0].tolist()
            assert port == expect, (seed, ctr)
            pairs = native.threefry2x32_batch(k2[0], k2[1], [0, 0, 0, 1, 0, 2, 0, 3, 0, 4])
            assert [pairs[2 * i] ^ pairs[2 * i + 1] for i in range(5)] == expect


_DIGEST_SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import madsim_tpu_torch as ms
from madsim_tpu_torch import context
from madsim_tpu_torch.examples.raft_host import run_seed
from madsim_tpu_torch.task import TimeLimitError

s = run_seed(123, sim_seconds=2.0)
out = {"raft": [s["leaders_elected"], s["violations"], s["msgs"], s["elections"]]}

async def draws():
    for _ in range(50):
        await ms.sleep(0.01)
        ms.rand.gen_range(0, 1000)
rt = ms.Runtime(seed=7)
rt.block_on(draws())
out["draws"] = [rt.rng._draw_count, rt.rng.next_u64()]

async def mid_drain():
    for _ in range(5):
        await ms.sleep(0.01)
        ms.rand.gen_range(0, 1000)
    context.current_handle().rng.enable_log()
    for _ in range(5):
        await ms.sleep(0.01)
        ms.rand.gen_range(0, 1000)
rt = ms.Runtime(seed=11)
rt.block_on(mid_drain())
log = rt.rng.take_log()
out["mid_drain_log"] = [len(log), sum(log) & (2**64 - 1)]

rt = ms.Runtime(seed=5)
async def limited():
    rt.set_time_limit(0.25)
    await ms.sleep(100.0)
try:
    rt.block_on(limited())
    out["time_limit"] = "no-error"
except TimeLimitError as e:
    out["time_limit"] = str(e)

out["core"] = ms.time._simloop is not None
out["ctypes_queue"] = type(rt.executor.ready).__name__
out["torch"] = "torch" in sys.modules
print(json.dumps(out))
"""

# the environments of the reference's tests: the compiled core (default),
# the pure-Python loop, and the older ctypes heap and queue
ENVS = {"core": {}, "python": {"MADSIM_NO_NATIVE": "1"}, "ctypes": {"MADSIM_NATIVE": "1"}}


@functools.lru_cache(maxsize=None)
def digests(env_name: str) -> dict:
    """The port's results of the reference's subprocess checks in a fresh
    interpreter under one of ``ENVS``."""
    env = dict(os.environ, **ENVS[env_name])
    env.pop("MADSIM_TEST_CHECK_DETERMINISM", None)
    proc = subprocess.run([sys.executable, "-c", _DIGEST_SCRIPT, REPO], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_native_timer_queue_schedule_identical():
    """A full simulation on the ctypes heap and queue (``MADSIM_NATIVE=1``)
    gives the default's output, and the reference's raft example's."""
    from examples.raft_host import run_seed

    assert digests("ctypes")["ctypes_queue"] == "_NativeReadyQueue"
    assert digests("ctypes")["raft"] == digests("core")["raft"]
    s = run_seed(123, sim_seconds=2.0)
    ref = [s["leaders_elected"], s["violations"], s["msgs"], s["elections"]]
    assert digests("core")["raft"] == json.loads(json.dumps(ref))


def test_simloop_builds():
    mod = native.simloop()
    assert mod is not None and mod.__name__ == "madsim_tpu_torch.native._simloop"
    assert os.path.dirname(mod.__file__) == BUILD
    assert P.time._simloop is mod and P.futures.Future is mod.Future
    assert native.build_error() is None and native.available()


def test_simloop_schedule_transparent():
    """The compiled core, the pure-Python loop and the ctypes backend give
    byte-equal results, each in a fresh interpreter that imports no torch."""
    core, py, ct = (digests(e) for e in ("core", "python", "ctypes"))
    assert (core["core"], py["core"]) == (True, False)
    assert core["raft"] == py["raft"] == ct["raft"]
    assert not (core["torch"] or py["torch"] or ct["torch"])


def test_simloop_draw_stream_identical():
    """Draw for draw: the C loop's direct buffer consumption leaves
    ``_draw_count`` and the next draw where the Python loop leaves them."""
    assert digests("core")["draws"] == digests("python")["draws"]


def test_simloop_mid_drain_enable_log_identical():
    """``enable_log()`` from inside a running task captures the same log on
    the compiled core as in pure Python."""
    core, py = digests("core")["mid_drain_log"], digests("python")["mid_drain_log"]
    assert core == py and core[0] > 0


def test_simloop_check_determinism_still_works():
    async def wl():
        for _ in range(10):
            await P.sleep(0.01)
            P.rand.gen_range(0, 10)

    P.Builder(seed=3, count=2, check_determinism=True).run(wl)


def test_simloop_mid_sim_time_limit_change_honored():
    core, py = digests("core")["time_limit"], digests("python")["time_limit"]
    assert core == py and "time limit exceeded" in core


def test_gc_threshold_restored_across_threads():
    """Concurrent ``block_on`` calls do not leak the relaxed GC threshold."""
    base = gc.get_threshold()

    def run(seed):
        rt = P.Runtime(seed=seed)

        async def m():
            for _ in range(20):
                await P.sleep(0.01)

        rt.block_on(m())

    ts = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert gc.get_threshold() == base


def test_each_package_runs_on_its_own_core():
    """Two ``_simloop`` extensions in one interpreter: a reference run and
    a port run, one after the other, each drive their own ``Timers``,
    ``Loop`` and ``Future`` types (never nested: the stdlib
    interposition is global)."""
    seen = []
    for ms in (R, P):
        rt = ms.Runtime(seed=3)

        async def main(ms=ms):
            fut = ms.spawn(ms.sleep(0.01))
            await fut
            return type(fut).__mro__

        mro = rt.block_on(main())
        core = (native if ms is P else rnative).simloop()
        assert type(rt.time._core) is core.Timers
        assert type(rt.executor._cloop) is core.Loop
        assert core.Future in mro and ms.futures.Future is core.Future
        seen.append(core)
    assert seen[0] is not seen[1] and seen[0].Future is not seen[1].Future
    assert seen[0].__name__ == "madsim_tpu.native._simloop"


_PORT_ONLY_SCRIPT = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import madsim_tpu_torch as P
import _torch_shim_programs as shims
print(json.dumps({"core": P.time._simloop is not None, "runs": shims.port_records()}))
"""


def test_port_on_its_core_equals_the_port_without_it():
    """The port on its compiled core against the port under
    ``MADSIM_NO_NATIVE=1`` in a fresh interpreter: every shim program's
    determinism log, draws, virtual ns and outputs, and the phase 18 (c)
    programs over 8 seeds, equal."""
    import _torch_shim_programs as shims

    here = shims.port_records()
    env = dict(os.environ, MADSIM_NO_NATIVE="1")
    proc = subprocess.run([sys.executable, "-c", _PORT_ONLY_SCRIPT, REPO, HERE],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    there = json.loads(proc.stdout.strip().splitlines()[-1])
    assert P.time._simloop is not None and there["core"] is False
    assert there["runs"] == here


def test_a_traced_run_takes_the_python_loop():
    """``tracing.Tracer`` wraps every poll, so it turns the compiled loop
    off for its run: the trace equals the reference's, and the schedule
    equals the untraced run's on the core."""
    import _torch_shim_programs as shims

    traced = []
    for ms in (R, P):
        rt = ms.Runtime(seed=5)
        tracer = ms.tracing.Tracer().install(rt)
        assert rt.executor._cloop is None
        rt.rng.enable_log()
        out = rt.block_on(shims.grpc_all_streaming_modes(ms))
        traced.append((out, rt.rng.take_log(), rt.time.now_ns, tracer.to_json()))
    assert traced[0] == traced[1] and len(traced[1][3]) > 2
    plain = shims.record(P, shims.grpc_all_streaming_modes, 5)
    assert (plain["out"], plain["log"], plain["now_ns"]) == traced[1][:3]
