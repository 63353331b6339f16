"""Port parity: the multi-process wire load rig
(``madsim_tpu_torch.serve.loadgen`` and its driver
``madsim_tpu_torch.wire_load``) against the reference's
``madsim_tpu.serve.loadgen`` and ``scripts/wire_load.py``.

- ``chaos_plan`` (``faults.compile_host`` through torch on the CPU
  against the reference's through jax) is the reference's for seeds 0-15
  at the run lengths of ``SMOKE_SCENARIO`` and ``DEFAULT_SCENARIO``;
  ``plan_roles``, ``fingerprint``, ``body_for`` and ``total_clients``
  equal the reference's;
- ``merge_history`` + ``check_wire_histories`` give the reference's
  histories and verdicts on the rows the rig's own clients recorded
  against a live cluster, and on a copy with one etcd read corrupted;
- the determinism report (seeded sequential transcripts on injected
  clocks) is the reference's as bytes, for seeds 0-1, both server kinds
  and telemetry on and off, and equals the JAX-made
  ``madsim_tpu_torch/data/wire_load_determinism.json``
  (``python tests/test_torch_wire_load.py --write``), which
  ``chip_smoke.py`` phase 20 (a) holds the port to;
- in a fresh interpreter, a small ``run_load`` passes its histories and
  replay gates and leaves torch, jax and the port's engine out of the
  rig's parent process (the chaos schedule compiles in a forked child);
- ``-m slow``: ``python -m madsim_tpu_torch.wire_load --smoke`` in a
  subprocess (the reference's ``test_wire_load_smoke_end_to_end``).
"""

import asyncio
import json
import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import madsim_tpu as R  # noqa: E402
import madsim_tpu_torch as P  # noqa: E402
from madsim_tpu.serve import loadgen as rload  # noqa: E402
from madsim_tpu_torch.serve import loadgen as pload  # noqa: E402

import _torch_wire as wires  # noqa: E402

GOLDEN = os.path.join(REPO, "madsim_tpu_torch", "data", "wire_load_determinism.json")
DET_SEEDS = (0, 1)

# a rig small enough for a tier-1 test: one worker, 16 clients, 1 s
TINY = dict(pload.SMOKE_SCENARIO, kafka_producers=4, kafka_groups=1, kafka_members=2,
            kafka_records=3, s3_clients=5, s3_ops=6, etcd_clients=5, etcd_ops=6, workers=1,
            run_secs=1.0)


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


@pytest.mark.parametrize("scenario", ["SMOKE_SCENARIO", "DEFAULT_SCENARIO"])
def test_chaos_plan_is_the_reference_plan(scenario):
    base = getattr(rload, scenario)
    assert getattr(pload, scenario) == base
    for seed in range(16):
        cfg = dict(base, seed=seed)
        assert pload.chaos_plan(cfg) == rload.chaos_plan(cfg), seed


def test_roles_bodies_and_fingerprints_are_the_reference_ones():
    for cfg in (rload.SMOKE_SCENARIO, rload.DEFAULT_SCENARIO, TINY):
        assert pload.plan_roles(cfg) == rload.plan_roles(cfg)
        assert pload.total_clients(cfg) == rload.total_clients(cfg)
    for client in (0, 7, 1055):
        for n in range(9):
            body = rload.body_for(client, n)
            assert pload.body_for(client, n) == body
            assert pload.fingerprint(body) == rload.fingerprint(body)
    assert (pload.TOPIC, pload.GROUP_PREFIX, pload.BUCKET) == (
        rload.TOPIC, rload.GROUP_PREFIX, rload.BUCKET)


def _recorded_rows() -> dict:
    """The rows ``TINY``'s clients record against a live port cluster,
    the worker run in this process (no fork)."""
    cfg = dict(TINY, roles=pload.plan_roles(TINY)[0], chaos_at=0.3)

    async def main():
        from madsim_tpu_torch.kafka.probe import ProbeClient, RealTransport

        cluster = pload.Cluster()
        addrs = await cluster.start()
        try:
            setup = ProbeClient(await RealTransport.connect(addrs["kafka"]))
            await setup.create_topics([(pload.TOPIC, cfg["partitions"])])
            setup.close()
            s3 = pload._HttpClient(*addrs["s3"])
            await s3.connect()
            await s3.request("PUT", f"/{pload.BUCKET}")
            s3.close()
            out = {}
            await pload._worker_async(0, dict(cfg, t0=time.time()), addrs, out)
            return out["rows"]
        finally:
            await cluster.stop()

    return asyncio.run(main())


def _corrupt_an_etcd_read(rows: list) -> list:
    from madsim_tpu_torch.oracle.history import OP_GET, PH_INVOKE, code_of

    done = code_of(OP_GET, PH_INVOKE) + 1
    i = next(i for i, r in enumerate(rows) if r[1] == done and r[3] >= 0)
    bad = list(rows)
    bad[i] = bad[i][:3] + (bad[i][3] + 12_345,) + bad[i][4:]
    return bad


def test_merged_histories_and_verdicts_are_the_reference_ones():
    rows = _recorded_rows()
    assert all(len(rows[w]) > 10 for w in ("kafka", "s3", "etcd")), {
        w: len(r) for w, r in rows.items()}
    for case in (rows, dict(rows, etcd=_corrupt_an_etcd_read(rows["etcd"]))):
        hists = {w: (rload.merge_history(r, 3), pload.merge_history(r, 3))
                 for w, r in case.items()}
        for w, (rh, ph) in hists.items():
            assert [tuple(op) for op in ph.ops] == [tuple(op) for op in rh.ops], w
        ref = rload.check_wire_histories({w: h[0] for w, h in hists.items()})
        assert pload.check_wire_histories({w: h[1] for w, h in hists.items()}) == ref
        assert ref["etcd"]["ok"] is (case is rows), ref
        assert ref["kafka"]["ok"] and ref["s3"]["ok"], ref
    empty = (rload.merge_history([], 0), pload.merge_history([], 0))
    assert (len(empty[0].ops), len(empty[1].ops)) == (0, 0)


def _golden() -> dict:
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.mark.parametrize("seed", DET_SEEDS)
@pytest.mark.parametrize("kind", ["async", "legacy"])
@pytest.mark.parametrize("telemetry", [True, False], ids=["telemetry", "no-telemetry"])
def test_determinism_report_is_the_reference_bytes(seed, kind, telemetry):
    ref = wires.determinism_bytes(R, kind, seed, telemetry)
    assert ref == wires.report_bytes(_golden()[str(seed)])
    assert wires.determinism_bytes(P, kind, seed, telemetry) == ref
    report = json.loads(ref)
    assert report["kafka"]["replay_ok"] and report["s3"]["replay_ok"]


def test_the_rig_parent_never_imports_torch():
    """A small ``run_load`` in a fresh interpreter: the gates hold, the
    chaos plan (compiled in the forked child) is the one computed here,
    and the parent never imported torch, jax or the port's engine."""
    code = (
        "import json, sys\n"
        "from madsim_tpu_torch.serve import loadgen\n"
        f"report = loadgen.run_load({TINY!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')\n"
        "             or m.startswith('madsim_tpu_torch.engine'))\n"
        "print(json.dumps({'bad': bad, 'report': report}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    report = out["report"]
    assert out["bad"] == []
    assert report["histories_ok"] and report["replay_ok"], report["history_checks"]
    assert report["missing_workers"] == 0 and not report["fatals"]
    assert report["clients"] == pload.total_clients(TINY) and report["total_ops"] > 0
    plan = pload.chaos_plan(dict(pload.DEFAULT_SCENARIO, **TINY))
    assert {k: report["chaos"][k] for k in plan} == plan


@pytest.mark.slow
def test_wire_load_smoke_end_to_end(tmp_path):
    """``SMOKE_SCENARIO`` through the port's rig (the reference's test of
    the same name): worker processes, checked histories, live-vs-replay
    identity and the async-vs-legacy parity."""
    path = tmp_path / "smoke.json"
    proc = subprocess.run(
        [sys.executable, "-m", "madsim_tpu_torch.wire_load", "--smoke", "--report", str(path)],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "smoke parity [async vs legacy" in proc.stdout
    with open(path) as f:
        report = json.load(f)
    assert report["parity"] and report["load"]["gate_failures"] == []
    assert report["load"]["clients"] == pload.total_clients(pload.SMOKE_SCENARIO)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_wire_load.py --write")
    golden = {str(seed): json.loads(wires.determinism_bytes(R, "async", seed, False))
              for seed in DET_SEEDS}
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {GOLDEN}")
