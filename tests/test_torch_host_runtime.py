"""Port parity: the host runtime (``madsim_tpu_torch``'s rand, time, task,
runtime, interpose, net, fs, sync, buggify, signal and builder) against
the reference's.

Every program below is written once and takes the package module as its
argument. The harness runs it under ``madsim_tpu.Runtime(seed)`` and
under ``madsim_tpu_torch.Runtime(seed)``, one after the other (the stdlib
interposition is global, so the two runs never nest), and holds the
determinism log (every rng draw hashed with its virtual time), the draw
count, the final virtual nanoseconds and the program's outputs equal.
Both packages run here on their compiled cores (``native/simloop.c``)
as they load by default; ``test_parity_without_the_reference_native_tier``
repeats every program, and every shim program of
``_torch_shim_programs.py``, in a fresh interpreter under
``MADSIM_NO_NATIVE=1`` (read when each package's native core loads, so
both run their pure-Python loops there). After every pair of runs the
stdlib's ``time.time``, ``random.random`` and ``datetime.datetime`` must
be the originals again.
"""

import json
import os
import random
import subprocess
import sys

import pytest

import madsim_tpu as R
import madsim_tpu_torch as P
from _torch_parity import assert_stdlib_restored, both, run, sub

PKGS = (R, P)
HERE = os.path.dirname(os.path.abspath(__file__))


# ---------------------------------------------------------------------------
# the programs


async def rand_and_buggify(ms):
    out = [ms.rand.random(), ms.rand.gen_range(3, 1000), ms.rand.uniform(-1.0, 1.0),
           ms.rand.next_u32(), ms.rand.getrandom(13).hex(), ms.rand.choice("abcdef")]
    seq = list(range(10))
    ms.rand.shuffle(seq)
    out.append(seq)
    out.append(ms.buggify.is_enabled())
    out.append(sum(ms.buggify.buggify() for _ in range(100)))
    ms.buggify.enable()
    out.append(sum(ms.buggify.buggify() for _ in range(500)))
    out.append(sum(ms.buggify.buggify_with_prob(0.9) for _ in range(100)))
    with ms.buggify.enabled(prob=1.0):
        out.append(ms.buggify.buggify())
    ms.buggify.disable()
    with ms.buggify.enabled():
        out.append(sum(ms.buggify.buggify() for _ in range(200)))
    out.append(ms.buggify.is_enabled())
    await ms.sleep(0.01)
    out.append(ms.rand.random())
    return out


async def sleep_timeout_interval(ms):
    log = []
    start = ms.time.now_instant()
    await ms.sleep(0.0001)  # clamped to 1 ms
    log.append(("min", ms.time.now_instant().ns - start.ns))
    await ms.sleep_until(ms.time.now_instant() + 0.25)
    log.append(("until", ms.time.elapsed()))

    async def slow(delay, value):
        await ms.sleep(delay)
        return value

    log.append(("ok", await ms.timeout(1.0, slow(0.5, "done"))))
    try:
        await ms.timeout(0.2, slow(0.5, "late"))
    except ms.TimeoutError as e:
        log.append(("expired", str(e), ms.time.elapsed()))
    h = ms.spawn(slow(0.3, "joined"))
    log.append(("future", await ms.timeout(1.0, h)))
    for behavior in ("BURST", "DELAY", "SKIP"):
        iv = ms.time.interval(0.1)
        iv.missed_tick_behavior = getattr(ms.time.MissedTickBehavior, behavior)
        ticks = [(await iv.tick()).ns]
        await ms.sleep(0.35)
        for _ in range(3):
            ticks.append((await iv.tick()).ns)
        log.append((behavior, ticks, ms.time.now_instant().ns))
    ms.time.advance(1.5)
    log.append(("advance", ms.time.now_instant().ns, ms.time.now(), ms.time.node_skew()))
    return log


async def spawn_abort_select_join(ms):
    order = []

    async def worker(i, n):
        for k in range(n):
            order.append((i, k))
            await ms.sleep(0.001 * (1 + ms.rand.gen_range(0, 5)))
        return i * 10

    hs = [ms.spawn(worker(i, 6), name=f"w{i}") for i in range(4)]
    victim = ms.spawn(worker(9, 100))
    await ms.sleep(0.004)
    victim.abort()
    try:
        await victim
        aborted = "no"
    except Exception as e:  # the package's CancelledError
        aborted = type(e).__name__
    results = await ms.join(*hs)

    async def inline_failure():
        await ms.sleep(0.002)
        raise ValueError("task failed")

    try:
        await ms.timeout(1.0, inline_failure())
    except ValueError as e:
        caught = str(e)
    fast, slow = ms.spawn(worker(20, 1)), ms.spawn(worker(21, 50))
    idx, val = await ms.select(slow, fast)
    slow.abort()

    async def leaf(i):
        order.append(("leaf", i))

    for i in range(8):
        ms.spawn(leaf(i))
    await ms.sleep(0.01)
    return {"order": order, "results": results, "aborted": aborted, "caught": caught,
            "select": [idx, val], "finished": [h.is_finished() for h in hs]}


async def sync_primitives(ms):
    sync = sub(ms, "sync")
    log = []
    tx, rx = sync.oneshot()

    async def send_later():
        await ms.sleep(0.01)
        tx.send(42)

    ms.spawn(send_later())
    log.append(("oneshot", await rx))

    btx, brx = sync.channel(2)

    async def producer(base):
        for i in range(4):
            await btx.send(base + i)
            log.append(("sent", base + i, ms.time.now_instant().ns))

    p1, p2 = ms.spawn(producer(0)), ms.spawn(producer(100))
    for _ in range(8):
        await ms.sleep(0.001)
        log.append(("recv", await brx.recv()))
    await ms.join(p1, p2)

    wtx, wrx = sync.watch(0)

    async def watcher():
        seen = []
        for _ in range(3):
            await wrx.changed()
            seen.append(wrx.borrow_and_update())
        return seen

    hw = ms.spawn(watcher())
    for v in (1, 2, 3):
        await ms.sleep(0.002)
        wtx.send(v)
    log.append(("watch", await hw))

    cast, _ = sync.broadcast(4)
    subs = [cast.subscribe() for _ in range(2)]
    for v in range(3):
        cast.send(v)
    log.append(("broadcast", [[await s.recv() for _ in range(3)] for s in subs]))

    note = sync.Notify()
    woke = []

    async def waiter(i):
        await note.notified()
        woke.append((i, ms.time.now_instant().ns))

    for i in range(3):
        ms.spawn(waiter(i))
    await ms.sleep(0.005)
    note.notify_one()
    await ms.sleep(0.005)
    note.notify_waiters()
    await ms.sleep(0.005)
    log.append(("notify", woke))

    mutex, inside = sync.Mutex(), []

    async def critical(i):
        async with mutex:
            inside.append((i, "in"))
            await ms.sleep(0.003)
            inside.append((i, "out"))

    await ms.join(*[ms.spawn(critical(i)) for i in range(4)])
    log.append(("mutex", inside))

    lock = sync.RwLock()
    r1, r2 = await lock.read(), await lock.read()
    r1.release()
    r2.release()
    w = await lock.write()
    w.release()
    sem = sync.Semaphore(2)
    g1, g2 = await sem.acquire(), await sem.acquire()
    log.append(("sem", sem.try_acquire() is None, sem.available_permits))
    g1.release()
    g2.release()
    barrier, parties = sync.Barrier(3), []

    async def party(i):
        await ms.sleep(0.001 * i)
        parties.append((i, await barrier.wait()))

    await ms.join(*[ms.spawn(party(i)) for i in range(3)])
    log.append(("barrier", parties))
    return log


async def endpoint_and_rpc(ms):
    net = sub(ms, "net")
    h = ms.current_handle()
    ns = h.simulator(net.NetSim)
    n1 = h.create_node().name("n1").ip("10.0.1.1").build()
    n2 = h.create_node().name("n2").ip("10.0.1.2").build()
    got = []

    class Ping(net.Request):
        def __init__(self, n):
            self.n = n

    async def server():
        ep = await net.Endpoint.bind("10.0.1.2:100")

        async def handle(req):
            return req.n + 1

        ep.add_rpc_handler(Ping, handle)
        while True:
            data, src = await ep.recv_from(7)
            got.append((data.decode(), src[0], ms.time.now_instant().ns))
            await ep.send_to(src, 8, data.upper())

    async def client():
        ep = await net.Endpoint.bind("0.0.0.0:0")
        await ms.sleep(0.1)
        out = []
        for i in range(6):
            await ep.send_to("10.0.1.2:100", 7, f"m{i}".encode())
            try:
                data, _ = await ms.timeout(0.5, ep.recv_from(8))
                out.append((data.decode(), ms.time.now_instant().ns))
            except ms.TimeoutError:
                out.append(("no echo", i, ms.time.now_instant().ns))
        try:
            out.append(("rpc", await ep.call_timeout("10.0.1.2:100", Ping(41), 1.0)))
        except ms.TimeoutError:
            out.append(("rpc lost", ms.time.now_instant().ns))
        ns.clog_node(n2.id)
        try:
            await ep.call_timeout("10.0.1.2:100", Ping(1), 1.0)
        except ms.TimeoutError:
            out.append(("clogged", ms.time.now_instant().ns))
        ns.unclog_node(n2.id)
        try:
            out.append(("unclogged", await ep.call_timeout("10.0.1.2:100", Ping(2), 5.0)))
        except ms.TimeoutError:
            out.append(("unclogged but lost", ms.time.now_instant().ns))
        ns.clog_link(n1.id, n2.id)
        ns.unclog_link(n1.id, n2.id)
        for cfg in (ns.config, ns.network.config):
            cfg.net.send_latency = (0.05, 0.2)
            cfg.net.packet_loss_rate = 0.5
        for i in range(12):
            try:
                out.append(("lossy", i, await ep.call_timeout("10.0.1.2:100", Ping(i), 1.0),
                            ms.time.now_instant().ns))
            except ms.TimeoutError:
                out.append(("lost", i, ms.time.now_instant().ns))
        return out

    n2.spawn(server())
    out = await n1.spawn(client())
    stat = ns.stat()
    return {"client": out, "server": got, "msgs": stat.msg_count}


async def fs_fsync_power_fail(ms):
    fs = ms.fs
    h = ms.current_handle()
    fssim = h.simulator(fs.FsSim)
    node = h.create_node().name("disk").build()
    log = []

    async def phase1():
        f = await fs.File.create("/wal")
        await f.write_all(b"synced")
        await f.sync_all()
        await f.write_all(b"+unsynced")
        await fs.write("/meta", b"m")

    await node.spawn(phase1())
    fssim.power_fail(node.id)

    async def read(path):
        try:
            return (await fs.read(path)).decode()
        except FileNotFoundError:
            return None

    log.append(("after power_fail", await node.spawn(read("/wal")),
                await node.spawn(read("/meta"))))
    fssim.stall_fsync(node.id)

    async def phase2():
        f = await fs.File.open("/wal")
        await f.write_all(b"+lied")
        await f.sync_all()
        return (await f.read_all()).decode()

    log.append(("stalled read", await node.spawn(phase2())))
    fssim.power_fail(node.id)
    log.append(("stalled power_fail", await node.spawn(read("/wal"))))

    async def phase3():
        f = await fs.File.open("/wal")
        await f.write_all(b"+caught")
        await f.sync_all()
        meta = await fs.metadata("/wal")
        return meta.len()

    log.append(("len", await node.spawn(phase3())))
    fssim.unstall_fsync(node.id)
    fssim.power_fail(node.id)
    log.append(("caught up", await node.spawn(read("/wal"))))
    h.restart(node)
    await ms.sleep(0.1)
    log.append(("restarted", await node.spawn(read("/wal")), ms.time.now_instant().ns))
    return log


async def kill_restart_pause_resume(ms):
    h = ms.current_handle()
    ticks, boots = [], []

    def init():
        async def body():
            boots.append(ms.time.now_instant().ns)
            while True:
                await ms.sleep(0.1 + 0.001 * ms.rand.gen_range(0, 50))
                ticks.append(("svc", ms.time.now_instant().ns))

        return body()

    svc = h.create_node().name("svc").init(init).build()
    other = h.create_node().name("other").build()

    async def ticker():
        while True:
            await ms.sleep(0.25)
            ticks.append(("other", ms.time.now_instant().ns))

    other.spawn(ticker())
    await ms.sleep(1.0)
    h.kill(svc)
    dead = h.is_exit(svc)
    await ms.sleep(0.5)
    h.restart(svc)
    await ms.sleep(0.5)
    h.pause(other)
    await ms.sleep(1.0)
    h.resume(other)
    await ms.sleep(0.6)

    def flaky_init():
        async def body():
            boots.append(("flaky", ms.time.now_instant().ns))
            if len(boots) < 5:
                raise RuntimeError("flaky service crash")
            await ms.sleep(10_000.0)

        return body()

    h.create_node().name("flaky").init(flaky_init).restart_on_panic().build()
    await ms.sleep(30.0)
    metrics = h.metrics()
    return {"ticks": ticks, "boots": boots, "dead": dead,
            "tasks": metrics.num_tasks(), "nodes": metrics.num_nodes()}


async def interposed_stdlib(ms):
    import os as _os
    import random as _random
    import time as _time
    import uuid as _uuid
    from datetime import date as _date
    from datetime import datetime as _datetime

    out = [_random.random(), _random.randint(1, 6), _random.uniform(0, 1),
           _random.choice([1, 2, 3]), _random.randrange(0, 100, 7),
           _random.getrandbits(70)]
    seq = list(range(8))
    _random.shuffle(seq)
    out.append(seq)
    out.append(_os.urandom(12).hex())
    out.append(str(_uuid.uuid4()))
    t0, m0, p0 = _time.time(), _time.monotonic_ns(), _time.perf_counter()
    await ms.sleep(1.5)
    out += [t0, _time.time() - t0, _time.time_ns(), _time.monotonic_ns() - m0,
            _time.perf_counter() - p0]
    out.append(_datetime.now().isoformat())
    out.append(_date.today().isoformat())
    h = ms.current_handle()
    node = h.create_node().name("big").cores(16).build()

    async def cores():
        return _os.cpu_count()

    out.append(await node.spawn(cores()))
    return out


PROGRAMS = {
    "rand_and_buggify": (rand_and_buggify, None),
    "sleep_timeout_interval": (sleep_timeout_interval, None),
    "spawn_abort_select_join": (spawn_abort_select_join, None),
    "sync_primitives": (sync_primitives, None),
    "endpoint_and_rpc": (endpoint_and_rpc, None),
    "endpoint_and_rpc_configured": (endpoint_and_rpc, {
        "net": {"packet_loss_rate": 0.1, "send_latency": [0.002, 0.02]}}),
    "fs_fsync_power_fail": (fs_fsync_power_fail, None),
    "kill_restart_pause_resume": (kill_restart_pause_resume, None),
    "interposed_stdlib": (interposed_stdlib, None),
}
SEEDS = (1, 7)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_parity(name):
    program, config = PROGRAMS[name]
    for seed in SEEDS:
        ref = both(program, seed, config)
        assert ref["draws"] > 0 and ref["now_ns"] > 0


def test_seeds_give_different_schedules():
    """The harness would pass two constant programs: make sure the
    programs really depend on the seed."""
    a = run(P, spawn_abort_select_join, 1)
    b = run(P, spawn_abort_select_join, 2)
    assert a["log"] != b["log"] and a["out"]["order"] != b["out"]["order"]


def check_all() -> dict:
    """Every program at every seed, both packages (for the subprocess),
    and every shim program of ``_torch_shim_programs`` at its seed."""
    import _torch_shim_programs as shims

    for name, (program, config) in sorted(PROGRAMS.items()):
        for seed in SEEDS:
            both(program, seed, config)
    for name, (program, seed) in sorted(shims.PROGRAMS.items()):
        both(program, seed)
    return {"programs": len(PROGRAMS) + len(shims.PROGRAMS),
            "native": [sub(ms, "time")._simloop is not None for ms in PKGS]}


def test_parity_without_the_reference_native_tier():
    """Both packages' pure-Python loops (``MADSIM_NO_NATIVE=1`` turns off
    both compiled cores) over every host and shim program."""
    import _torch_shim_programs as shims

    for ms in PKGS:
        assert sub(ms, "time")._simloop is not None, f"{ms.__name__}'s compiled core did not load"
    env = dict(os.environ, MADSIM_NO_NATIVE="1", PYTHONPATH=os.path.dirname(HERE))
    code = ("import json, test_torch_host_runtime as t\n"
            "print(json.dumps(t.check_all()))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "programs": len(PROGRAMS) + len(shims.PROGRAMS), "native": [False, False]}


# ---------------------------------------------------------------------------
# the determinism checker, the builder and the procs guard


def test_check_determinism_raises_at_the_same_time_and_draw():
    async def steady(ms):
        total = 0.0
        for _ in range(10):
            await ms.sleep(random.uniform(0.001, 0.1))
            total += random.random()
        return total

    got = [ms.Runtime.check_determinism(42, lambda ms=ms: steady(ms)) for ms in PKGS]
    assert got[0] == got[1]
    assert_stdlib_restored()

    errors = []
    for ms in PKGS:
        state = {"runs": 0}

        async def leaky(ms=ms, state=state):
            state["runs"] += 1
            for _ in range(4):
                await ms.sleep(0.01 * ms.rand.gen_range(1, 4))
            for _ in range(3 if state["runs"] == 1 else 5):
                ms.rand.random()
            await ms.sleep(0.02)

        with pytest.raises(sub(ms, "rand").NondeterminismError) as e:
            ms.Runtime.check_determinism(7, leaky)
        errors.append((e.value.sim_time_ns, e.value.draw_index, str(e.value)))
        assert_stdlib_restored()
    assert errors[0] == errors[1]


def _builder_run(ms, seeds_out):
    async def body():
        seed = ms.current_handle().seed
        await ms.sleep(0.001 * ms.rand.gen_range(1, 50))
        seeds_out.append((seed, ms.time.now_instant().ns, ms.rand.next_u64()))
        return seed

    return ms.Builder.from_env().run(body)


def test_builder_under_the_environment(monkeypatch, capsys):
    monkeypatch.setenv("MADSIM_TEST_SEED", "77")
    monkeypatch.setenv("MADSIM_TEST_NUM", "4")
    outs = []
    for ms in PKGS:
        seen = []
        last = _builder_run(ms, seen)
        b = ms.Builder.from_env()
        outs.append((last, seen, b.seed, b.count, b.jobs, b.procs, b.check_determinism))
    assert outs[0] == outs[1]
    assert [s for s, _, _ in outs[1][1]] == [77, 78, 79, 80]

    monkeypatch.setenv("MADSIM_TEST_JOBS", "2")
    monkeypatch.setenv("MADSIM_TEST_CHECK_DETERMINISM", "1")
    jobs = []
    for ms in PKGS:
        seen = []
        _builder_run(ms, seen)
        jobs.append(sorted(seen))
    assert jobs[0] == jobs[1] and len(jobs[1]) == 8  # each seed twice
    monkeypatch.delenv("MADSIM_TEST_JOBS")
    monkeypatch.delenv("MADSIM_TEST_CHECK_DETERMINISM")

    monkeypatch.setenv("MADSIM_TEST_NUM", "5")
    failures = []
    for ms in PKGS:
        @ms.sim_test
        async def failing(ms=ms):
            await ms.sleep(0.01)
            if ms.current_handle().seed == 79:
                raise AssertionError(f"seed-specific failure at {ms.time.now_instant().ns}")

        with pytest.raises(AssertionError) as e:
            failing()
        failures.append((str(e.value), capsys.readouterr().err))
    assert failures[0] == failures[1]
    assert "MADSIM_TEST_SEED=79" in failures[1][1]

    monkeypatch.setenv("MADSIM_TEST_NUM", "1")
    monkeypatch.setenv("MADSIM_TEST_TIME_LIMIT", "10")
    limits = []
    for ms in PKGS:
        async def forever(ms=ms):
            await ms.sleep(1e6)

        with pytest.raises(sub(ms, "task").TimeLimitError) as e:
            ms.Builder.from_env().run(forever)
        limits.append(str(e.value))
    assert limits[0] == limits[1]
    assert_stdlib_restored()


def test_procs_sweep_matches_the_reference():
    async def wl():
        import madsim_tpu_torch as ms

        total = 0
        for _ in range(5):
            await ms.sleep(0.01)
            total += ms.rand.gen_range(0, 100)
        return total

    async def ref_wl():
        total = 0
        for _ in range(5):
            await R.sleep(0.01)
            total += R.rand.gen_range(0, 100)
        return total

    par = P.Builder(seed=100, count=6, procs=3).run(wl)
    assert par == P.Builder(seed=100, count=6).run(wl) == R.Builder(seed=100, count=6).run(ref_wl)


def test_procs_guard_raises_the_named_error():
    """A ``Builder(procs=N)`` child that touches the device tier fails
    fast by name in both packages: the reference's through its engine,
    the port's through its engine, through torch and through CUDA."""
    import torch  # noqa: F401  (torch is loaded before the fork)

    from madsim_tpu_torch.builder import ProcsDeviceTierError, SimSweepError

    async def port_engine():
        from madsim_tpu_torch.engine import core
        from madsim_tpu_torch.models import raft

        cfg = raft.RaftConfig(num_nodes=3)
        core.init_sweep(raft.workload(cfg), raft.engine_config(cfg), [0, 1], device="cpu")

    async def port_torch():
        import torch

        return torch.zeros(2)

    async def port_cuda():
        return P.resolve_device()

    for wl in (port_engine, port_torch, port_cuda):
        with pytest.raises(SimSweepError) as e:
            P.Builder(seed=0, count=2, procs=2).run(wl)
        assert "ProcsDeviceTierError" in str(e.value), wl.__name__
    assert issubclass(ProcsDeviceTierError, RuntimeError)

    from madsim_tpu.builder import SimSweepError as RefSweepError

    async def ref_engine():
        from madsim_tpu.engine import core
        from madsim_tpu.models import raft

        cfg = raft.RaftConfig(num_nodes=3)
        core.run_sweep(raft.workload(cfg), raft.engine_config(cfg), [0, 1])

    with pytest.raises(RefSweepError) as e:
        R.Builder(seed=0, count=2, procs=2).run(ref_engine)
    assert "ProcsDeviceTierError" in str(e.value)


def test_procs_guard_blocks_a_fresh_torch_import():
    """Even when the parent never imported torch, a child's fresh
    ``import torch`` raises the named error."""
    script = (
        "import sys\n"
        "from madsim_tpu_torch.builder import Builder, SimSweepError\n"
        "assert 'torch' not in sys.modules\n"
        "async def wl():\n"
        "    import torch\n"
        "    return torch.zeros(2)\n"
        "try:\n"
        "    Builder(seed=0, count=2, procs=2).run(wl)\n"
        "    print('NO-ERROR')\n"
        "except SimSweepError as e:\n"
        "    print('named' if 'ProcsDeviceTierError' in str(e) else 'other')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("named"), (proc.stdout, proc.stderr)
