"""Port parity: the host fault supervisor (``madsim_tpu_torch.faults``:
``compile_host``, ``apply_schedule``, ``run_campaign``) against the
reference's, under the reference's supervisor scenarios
(``tests/test_faults.py``: partitions and bursts, gray actions, the
power-fail machinery of ``tests/test_fs.py``, and whole campaigns of
``FULL_SPEC`` and ``GRAY_SPEC`` against live nodes).

Each scenario is written once, takes the package module and its
``FaultSpec``/``FixedFaults`` as arguments, and runs under both packages'
``Runtime(seed)``, one after the other; what it observes, the determinism
log and the final virtual nanoseconds must be equal."""

import importlib

import pytest

import madsim_tpu as R
import madsim_tpu_torch as P
from madsim_tpu.engine import faults as refaults
from madsim_tpu_torch.engine import faults as pefaults

from _torch_parity import port_spec
from test_torch_host_runtime import assert_stdlib_restored

# tests/test_faults.py's specs: every category, then every gray family
FULL = dict(
    crashes=2, crash_window_ns=1_500_000_000, restart_lo_ns=100_000_000,
    restart_hi_ns=400_000_000, partitions=2, part_window_ns=1_500_000_000,
    part_lo_ns=200_000_000, part_hi_ns=600_000_000, spikes=1,
    spike_window_ns=1_500_000_000, spike_dur_lo_ns=200_000_000,
    spike_dur_hi_ns=500_000_000, losses=1, loss_window_ns=1_500_000_000,
    loss_dur_lo_ns=200_000_000, loss_dur_hi_ns=500_000_000, pauses=1,
    pause_window_ns=1_500_000_000, pause_lo_ns=100_000_000, pause_hi_ns=300_000_000,
)
GRAY = dict(
    crashes=1, crash_window_ns=1_000_000_000, restart_lo_ns=100_000_000,
    restart_hi_ns=400_000_000, aparts=2, apart_window_ns=1_200_000_000,
    apart_lo_ns=200_000_000, apart_hi_ns=600_000_000, fsync_stalls=1,
    fsync_window_ns=1_200_000_000, fsync_lo_ns=300_000_000, fsync_hi_ns=800_000_000,
    power_fails=1, power_window_ns=1_500_000_000, power_lo_ns=50_000_000,
    power_hi_ns=300_000_000, skews=1, skew_window_ns=1_200_000_000,
    skew_lo_ns=300_000_000, skew_hi_ns=800_000_000,
)
SPECS = {"full": FULL, "gray": GRAY}


def sub(ms, name):
    return importlib.import_module(f"{ms.__name__}.{name}")


def spec_of(ms, fields):
    return (refaults if ms is R else pefaults).FaultSpec(**fields)


def run_both(scenario, seed=1, **kw):
    outs = []
    for ms in (R, P):
        rt = ms.Runtime(seed=seed)
        rt.rng.enable_log()
        out = rt.block_on(scenario(ms, **kw))
        outs.append({"out": out, "now_ns": rt.time.now_ns, "log": rt.rng.take_log()})
        assert_stdlib_restored()
    assert outs[1] == outs[0]
    return outs[1]["out"]


async def partitions_and_bursts(ms):
    """tests/test_faults.py::test_host_supervisor_applies_partitions_and_bursts."""
    net, hfaults = sub(ms, "net"), sub(ms, "faults")
    spec = spec_of(ms, FULL)
    schedule = [
        (100_000_000, "partition", 1), (150_000_000, "partition", 1),
        (200_000_000, "spike_on", 0), (250_000_000, "loss_on", 0),
        (300_000_000, "heal", 1), (400_000_000, "spike_off", 0),
        (450_000_000, "loss_off", 0), (500_000_000, "heal", 1),
        (600_000_000, "pause", 0), (700_000_000, "resume", 0),
        (800_000_000, "crash", 1), (900_000_000, "restart", 1),
    ]
    observed = {}
    h = ms.current_handle()
    ns = h.simulator(net.NetSim)
    nodes = [h.create_node().name(f"n{i}").build() for i in range(2)]
    base_latency = ns.config.net.send_latency

    async def probe():
        await ms.sleep(0.35)
        observed["clogged_mid"] = ns.network.is_clogged(nodes[1].id, nodes[0].id)
        observed["lat_mid"] = ns.config.net.send_latency
        observed["loss_mid"] = ns.config.net.packet_loss_rate

    ms.spawn(probe())
    await hfaults.apply_schedule(schedule, nodes, spec=spec)
    observed["clogged_end"] = ns.network.is_clogged(nodes[1].id, nodes[0].id)
    observed["lat_end"] = ns.config.net.send_latency
    observed["loss_end"] = ns.config.net.packet_loss_rate
    observed["base_latency"] = base_latency
    observed["exit"] = [h.is_exit(n) for n in nodes]
    return observed


async def gray_actions(ms):
    """tests/test_faults.py::test_host_supervisor_applies_gray_actions."""
    net, hfaults, runtime = sub(ms, "net"), sub(ms, "faults"), sub(ms, "runtime")
    schedule = [
        (100_000_000, "part_in", 1), (150_000_000, "partition", 1),
        (200_000_000, "skew_on", 0), (300_000_000, "heal", 1),
        (400_000_000, "heal_in", 1), (500_000_000, "skew_off", 0),
    ]
    observed = {}
    h = ms.current_handle()
    ns = h.simulator(net.NetSim)
    nodes = [h.create_node().name(f"n{i}").build() for i in range(2)]

    async def probe():
        await ms.sleep(0.25)
        observed["in_mid"] = ns.network.is_clogged(nodes[0].id, nodes[1].id)
        observed["out_mid"] = ns.network.is_clogged(nodes[1].id, nodes[0].id)
        observed["skew_mid"] = h.time.node_skew_of(runtime._node_id(nodes[0]))
        await ms.sleep(0.1)
        observed["in_after_heal"] = ns.network.is_clogged(nodes[0].id, nodes[1].id)
        observed["out_after_heal"] = ns.network.is_clogged(nodes[1].id, nodes[0].id)

    ms.spawn(probe())
    await hfaults.apply_schedule(schedule, nodes, spec=spec_of(ms, GRAY))
    observed["in_end"] = ns.network.is_clogged(nodes[0].id, nodes[1].id)
    observed["skew_end"] = h.time.node_skew_of(runtime._node_id(nodes[0]))
    return observed


async def power_fail_machinery(ms):
    """tests/test_fs.py::test_fault_schedule_drives_power_fail_machinery."""
    fs, hfaults = ms.fs, sub(ms, "faults")
    fixed = (refaults if ms is R else pefaults).FixedFaults(events=(
        (200_000_000, "fsync_stall", 0), (500_000_000, "power_fail", 0),
        (700_000_000, "restart", 0), (900_000_000, "fsync_ok", 0),
    ))
    h = ms.current_handle()
    node = h.create_node().name("db").build()
    seen = []

    async def writer():
        await fs.write("/durable", b"d")
        await ms.sleep(0.3)
        f = await fs.File.create("/wal")
        await f.write_all(b"stalled")
        await f.sync_all()

    node.spawn(writer())
    schedule = await hfaults.run_campaign(fixed, [node])

    async def read(path):
        try:
            return (await fs.read(path)).decode()
        except FileNotFoundError:
            return None

    seen.append([await node.spawn(read(p)) for p in ("/durable", "/wal")])
    return {"schedule": schedule, "seen": seen, "t": ms.time.now_instant().ns}


async def campaign_on_live_nodes(ms, which, campaign_seed):
    """``run_campaign`` of a whole spec against three nodes that ping
    each other over Endpoints and keep a synced counter file."""
    net, hfaults, fs = sub(ms, "net"), sub(ms, "faults"), ms.fs
    h = ms.current_handle()
    log = []

    def init(i):
        def make():
            async def body():
                ep = await net.Endpoint.bind((f"10.0.0.{i + 1}", 700))
                try:
                    n = int((await fs.read("/count")).decode())
                except FileNotFoundError:
                    n = 0
                log.append(("boot", i, n, ms.time.now_instant().ns))

                async def receiver():
                    while True:
                        msg, src = await ep.recv_from(1)
                        log.append(("recv", i, msg, src[0], ms.time.now_instant().ns))

                ms.spawn(receiver())
                while True:
                    await ms.sleep(0.05 + 0.001 * ms.rand.gen_range(0, 20))
                    n += 1
                    await fs.write("/count", str(n).encode())
                    dst = (i + 1 + ms.rand.gen_range(0, 2)) % 3
                    await ep.send_to((f"10.0.0.{dst + 1}", 700), 1, (i, n))

            return body()

        return make

    nodes = [h.create_node().name(f"n{i}").ip(f"10.0.0.{i + 1}").init(init(i)).build()
             for i in range(3)]
    schedule = await hfaults.run_campaign(spec_of(ms, SPECS[which]), nodes, seed=campaign_seed)
    await ms.sleep(0.5)
    return {"schedule": schedule, "log": log, "exit": [h.is_exit(n) for n in nodes],
            "msgs": h.simulator(net.NetSim).stat().msg_count}


def test_partitions_and_bursts():
    out = run_both(partitions_and_bursts)
    assert out["clogged_mid"] and not out["clogged_end"]
    assert out["lat_end"] == out["base_latency"] and out["loss_end"] == 0.0


def test_gray_actions():
    out = run_both(gray_actions)
    assert out["in_mid"] and out["out_mid"] and out["in_after_heal"]
    assert not out["out_after_heal"] and not out["in_end"] and out["skew_end"] == (1, 1)


def test_power_fail_machinery():
    out = run_both(power_fail_machinery)
    assert out["seen"] == [["d", None]]


@pytest.mark.parametrize("which", sorted(SPECS))
def test_campaign_on_live_nodes(which):
    for seed, campaign_seed in ((1, 0), (2, 11)):
        out = run_both(campaign_on_live_nodes, seed=seed, which=which,
                       campaign_seed=campaign_seed)
        assert len(out["schedule"]) == pefaults.num_events(pefaults.FaultSpec(**SPECS[which]))
        assert out["msgs"] > 0


def test_compile_host_equals_the_reference():
    from madsim_tpu import faults as rhost

    from madsim_tpu_torch import faults as phost
    from madsim_tpu_torch import replay as preplay

    for fields in (FULL, GRAY):
        for n, seed in ((3, 0), (4, 17), (5, 1 << 40)):
            rspec = refaults.FaultSpec(**fields)
            assert phost.compile_host(port_spec(rspec), n, seed) == rhost.compile_host(rspec, n, seed)
    assert preplay.compile_host is phost.compile_host  # one copy
    with pytest.raises(ValueError, match="FaultSpec"):
        async def needs_spec():
            await phost.apply_schedule([(1_000, "spike_on", 0)], [0])

        P.Runtime(seed=1).block_on(needs_spec())
