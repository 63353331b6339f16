"""Port parity: what the port's drivers record into the port's
``obs.Telemetry`` against what the reference's drivers record into the
reference's, on the same inputs.

A record is every counter and gauge that is not a wall time (its name,
help, labels and values), the observation count of each histogram series
(wall-time buckets are not compared), and the journal's events in order
with their kinds and fields, wall timestamps and ``*_s`` wall fields set
aside (both handles share one fixed run ID, so ``run`` is compared). The
drivers: the pipelined and the streaming checked etcd sweeps, the raft
sweep with the device-side event-mix plane, the coverage-guided and the
steered campaigns, the fleet store's quarantine counter, and the checked
sweep on a seed mesh of two ranks (the port's rank 0, whose host phase is
the mesh's, against the reference on two CPU devices). Each run also
holds its report to the reference's bytes, and the trace to the
reference's spans (the port adds a ``host check`` span per chunk of the
incremental checked sweep, which the reference's trace lacks).

``JAX_PLATFORMS=cpu python tests/test_torch_obs_drivers.py --write``
writes ``madsim_tpu_torch/data/obs_event_mix.json`` from the reference:
the event-mix report of ``chip_smoke.py`` phase 19 (c) at its card and
rehearsal sizes (``EVENT_MIX_RUNS``).
"""

import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import madsim_tpu.engine  # noqa: E402,F401  (the reference's int64 mode)
from madsim_tpu import obs as robs  # noqa: E402
from madsim_tpu_torch import obs as pobs  # noqa: E402

from _torch_obs_record import RUN_ID, record, spans  # noqa: E402

def both(tmp_path, run):
    """``run(pkg, telemetry) -> report`` once per package, each with a
    handle of its own package (journal and trace on); (reference, port)
    as dicts of report, record, spans and the port's trace path."""
    out = []
    for tag, obs in (("reference", robs), ("port", pobs)):
        jpath, tpath = tmp_path / f"{tag}.jsonl", tmp_path / f"{tag}.trace.json"
        tel = obs.Telemetry(journal=str(jpath), trace=str(tpath), run_id=RUN_ID)
        report = run(tag, tel)
        tel.close()
        out.append({"report": report, "record": record(obs, tel, jpath),
                    "trace": str(tpath)})
    return out


def assert_same_record(ref, port, drop_spans=("host check",)):
    assert json.dumps(port["report"], sort_keys=True, default=str) == \
        json.dumps(ref["report"], sort_keys=True, default=str)
    assert port["record"]["metrics"] == ref["record"]["metrics"]
    assert port["record"]["journal"] == ref["record"]["journal"]
    assert spans(port["trace"], drop_spans) == spans(ref["trace"])


# -- the checked etcd sweeps (phase 19 (a) and (b)'s cell, cut) --------------

SEEDS = np.arange(100, dtype=np.int64)
CHUNK = 32


def _etcd_pair():
    from madsim_tpu.models import etcd as retcd
    from madsim_tpu_torch.models import etcd as petcd

    from _torch_parity import port_ecfg

    rcfg = retcd.EtcdConfig(hist_slots=48, bug_stale_read=True)
    ecfg = retcd.engine_config(rcfg, time_limit_ns=1_000_000_000)
    pcfg = petcd.EtcdConfig(**rcfg._asdict())
    return {"reference": (retcd, rcfg, ecfg), "port": (petcd, pcfg, port_ecfg(ecfg))}


@pytest.mark.parametrize("driver", ["chunked", "stream"])
def test_checked_etcd_sweep_records_equal(tmp_path, driver):
    from madsim_tpu.oracle import screen as rscreen
    from madsim_tpu_torch.oracle import screen as pscreen

    cases = _etcd_pair()

    def run(tag, tel):
        mod, cfg, ecfg = cases[tag]
        screen = rscreen if tag == "reference" else pscreen
        kw = {} if tag == "reference" else {"device": "cpu"}
        return screen.checked_sweep(mod.workload(cfg), ecfg, SEEDS, mod.history_spec(),
                                    mod.sweep_summary, chunk_size=CHUNK, workers=2,
                                    driver=driver, telemetry=tel, **kw)

    ref, port = both(tmp_path, run)
    assert_same_record(ref, port)
    kinds = [r["kind"] for r in port["record"]["journal"]]
    per_chunk = "chunk" if driver == "chunked" else "flush"
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert kinds.count(per_chunk) == -(-len(SEEDS) // CHUNK)
    assert port["report"]["hist_violations"] > 0
    if driver == "chunked":
        assert {"host check lo=0", "device chunk lo=32"} <= {n for _, n, _ in spans(port["trace"])}
    else:
        assert any(ph == "C" and name == "stream occupancy" for ph, name, _ in spans(port["trace"]))


# -- the raft sweep with the event-mix plane (phase 19 (c), cut) -------------

MIX_REHEARSAL = chip_smoke.EVENT_MIX_RUNS[1]


def event_mix_case(pkg: str, size: dict):
    """(workload, engine config, summary) of phase 19 (c)'s raft cell
    (``chip_smoke.event_mix_path``) in either package."""
    from madsim_tpu_torch.models import raft as praft

    from _torch_parity import port_ecfg

    wl, ecfg = chip_smoke.event_mix_path(size)
    if pkg == "port":
        return wl, ecfg, praft.sweep_summary
    from madsim_tpu.models import raft

    cfg = raft.RaftConfig(num_nodes=5, crashes=1, event_mix=True)
    ref = raft.engine_config(cfg, queue_capacity=chip_smoke.CAPACITY,
                             time_limit_ns=size["time_limit_ns"], max_steps=chip_smoke.MAX_STEPS)
    assert port_ecfg(ref) == ecfg
    return raft.workload(cfg), ref, raft.sweep_summary


def reference_event_mix(size: dict) -> dict:
    from madsim_tpu.engine import checkpoint

    wl, ecfg, summary = event_mix_case("reference", size)
    return checkpoint.run_sweep_pipelined(wl, ecfg, np.arange(size["seeds"], dtype=np.int64),
                                          summary, chunk_size=size["chunk"])


def test_event_mix_sweep_records_equal(tmp_path):
    from madsim_tpu.engine import checkpoint as rcheckpoint
    from madsim_tpu_torch.engine import checkpoint as pcheckpoint

    seeds = np.arange(MIX_REHEARSAL["seeds"], dtype=np.int64)

    def run(tag, tel):
        wl, ecfg, summary = event_mix_case(tag, MIX_REHEARSAL)
        if tag == "reference":
            return rcheckpoint.run_sweep_pipelined(wl, ecfg, seeds, summary,
                                                   chunk_size=MIX_REHEARSAL["chunk"],
                                                   telemetry=tel)
        return pcheckpoint.run_sweep_pipelined(wl, ecfg, seeds, summary,
                                               chunk_size=MIX_REHEARSAL["chunk"],
                                               telemetry=tel, device="cpu")

    ref, port = both(tmp_path, run)
    assert_same_record(ref, port)
    mix = port["report"]["event_mix"]
    by_kind = {key[0]: v for name, _, _, _, rows in port["record"]["metrics"]
               if name == "engine_events_by_kind_total" for key, v in rows}
    assert by_kind == {str(k): float(v) for k, v in enumerate(mix)} and sum(mix) > 0
    golden = chip_smoke.load_golden(chip_smoke.EVENT_MIX_GOLDEN)["runs"]
    assert json.dumps(port["report"], sort_keys=True) == \
        golden[chip_smoke.event_mix_key(MIX_REHEARSAL)]


# -- the campaigns -------------------------------------------------------------

def test_campaign_records_equal(tmp_path):
    from madsim_tpu import explore as rexplore
    from madsim_tpu_torch import explore as pexplore

    def run(tag, tel):
        explore = rexplore if tag == "reference" else pexplore
        target, base = explore.targets.amnesia_gate(smoke=True)
        ccfg = explore.CampaignConfig(rounds=3, seeds_per_round=32, chunk_size=32)
        kw = {} if tag == "reference" else {"device": "cpu"}
        path = str(tmp_path / f"{tag}.campaign.jsonl")
        res = explore.run_campaign(target, base, ccfg, report_path=path, telemetry=tel, **kw)
        with open(path) as f:
            return {"report": f.read(), "records": res.records}

    ref, port = both(tmp_path, run)
    assert_same_record(ref, port)
    assert [r["kind"] for r in port["record"]["journal"]].count("round") == 3


# tests/test_torch_steer.py's families and raft cell
FAMILIES = (0x001, 0x002, 0x003, 0x004, 0x008, 0x010, 0x020, 0x040, 0x080, 0x100)


def test_steered_campaign_records_equal(tmp_path):
    from madsim_tpu import explore as rexplore
    from madsim_tpu_torch import explore as pexplore

    def run(tag, tel):
        explore = rexplore if tag == "reference" else pexplore
        target, base = explore.steer_gate(smoke=True)
        ccfg = explore.CampaignConfig(rounds=999, seeds_per_round=16, campaign_seed=7,
                                      max_recorded_seeds=2, scheduler="bandit")
        scfg = explore.SteerConfig(families=FAMILIES, escalate_seeds=8, kill_plays=1,
                                   budget_events=6_000, pipeline=1)
        kw = {} if tag == "reference" else {"device": "cpu"}
        path = str(tmp_path / f"{tag}.steer.jsonl")
        explore.run_campaign(target, base, ccfg, report_path=path, steer_cfg=scfg,
                             telemetry=tel, **kw)
        with open(path) as f:
            return f.read()

    ref, port = both(tmp_path, run)
    assert_same_record(ref, port)
    assert "steer_round" in [r["kind"] for r in port["record"]["journal"]]


def test_store_quarantine_counter_records_equal(tmp_path):
    """``tests/test_fleet.py``'s bit-flip case with a real handle."""
    from madsim_tpu.explore import store as rstore
    from madsim_tpu_torch.explore import store as pstore

    def run(tag, tel):
        store = rstore if tag == "reference" else pstore
        root = str(tmp_path / f"{tag}.store")
        st = store.CorpusStore(root, worker="w0", telemetry=tel)
        st.append(store.KIND_BUG, "fp-a", {"seed": 7, "spec": {"crashes": 1}})
        st.append(store.KIND_BUG, "fp-b", {"seed": 9, "spec": {"crashes": 2}})
        st.close()
        with open(st._log_path, "rb") as f:
            data = f.read()
        i = data.index(b'"seed": 7')
        with open(st._log_path, "wb") as f:
            f.write(data[:i] + b'"seed": 8' + data[i + 9:])
        reader = store.CorpusStore(root, worker="r", telemetry=tel)
        records, stats = reader.read_records()
        return {"stats": list(stats), "payloads": [r["payload"] for r in records]}

    ref, port = both(tmp_path, run)
    assert_same_record(ref, port)
    counters = {m[0]: m[4] for m in port["record"]["metrics"]}
    assert counters["fleet_store_quarantined_total"] == [((), 1.0)]


# -- the checked sweep on a seed mesh of two ranks ---------------------------


def test_mesh_checked_sweep_records_equal(tmp_path):
    from madsim_tpu.oracle import screen as rscreen
    from madsim_tpu_torch.parallel import World

    import _torch_mesh_jobs as jobs
    from _torch_parity import ref_mesh

    mod, cfg, ecfg = _etcd_pair()["reference"]
    jpath = tmp_path / "reference.jsonl"
    tel = robs.Telemetry(journal=str(jpath), run_id=RUN_ID)
    want = rscreen.checked_sweep(mod.workload(cfg), ecfg, SEEDS, mod.history_spec(),
                                 mod.sweep_summary, mesh=ref_mesh(2),
                                 chunk_per_device=jobs.MESH_TELEMETRY["chunk_per_device"],
                                 telemetry=tel)
    tel.close()
    want_record = record(robs, tel, jpath)
    world = World(2, device="cpu")
    try:
        (report0, record0), (report1, record1) = world.run(jobs.checked_telemetry,
                                                             str(tmp_path))
    finally:
        world.close()
    assert report0 == report1 == json.dumps(want, sort_keys=True)
    assert record0 == want_record
    gauges = {m[0]: m[4] for m in record1["metrics"]}
    assert gauges["mesh_devices"] == [((), 2.0)]


# -- the golden of phase 19 (c) ----------------------------------------------


def test_golden_holds_the_reference_rehearsal_report():
    golden = chip_smoke.load_golden(chip_smoke.EVENT_MIX_GOLDEN)["runs"]
    assert sorted(golden) == sorted(chip_smoke.event_mix_key(r) for r in chip_smoke.EVENT_MIX_RUNS)
    want = reference_event_mix(MIX_REHEARSAL)
    assert json.dumps(want, sort_keys=True) == golden[chip_smoke.event_mix_key(MIX_REHEARSAL)]
    assert "event_mix" in json.loads(golden[chip_smoke.event_mix_key(chip_smoke.EVENT_MIX_RUNS[0])])


def _write():
    runs = {chip_smoke.event_mix_key(r): json.dumps(reference_event_mix(r), sort_keys=True)
            for r in chip_smoke.EVENT_MIX_RUNS}
    path = chip_smoke.data_path(chip_smoke.EVENT_MIX_GOLDEN)
    with open(path, "w") as f:
        json.dump({"config": "RaftConfig(num_nodes=5, crashes=1, event_mix=True), queue 64",
                   "runs": runs}, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_obs_drivers.py --write")
    _write()
