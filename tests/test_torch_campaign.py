"""Port parity: the campaign loop on the seed mesh
(``madsim_tpu_torch.explore.run_campaign``, ``sharded_campaign`` and
``checked_sweep_curve``) — the port's counterparts of
``tests/test_explore.py``'s campaign and ``tests/test_parallel.py``'s
campaign matrix.

``run_campaign``'s JSONL report equals the reference's byte for byte on
1 rank, and on 2 ranks through ``sharded_campaign`` resuming the 1-rank
campaign's checkpoint (its last round recomputed); ``checked_sweep_curve``'s
report hash per world size equals the reference's on as many devices.
The port's ranks are a gloo world of spawned CPU ranks per world size
(``parallel.World``); the reference campaign runs unsharded (its report
bytes are mesh-invariant, ``tests/test_parallel.py``)."""

import json
import os
import shutil

import pytest

import madsim_tpu.engine  # noqa: F401  (the reference's int64 mode)
from madsim_tpu import explore as rexplore
from madsim_tpu.engine.faults import FaultSpec as RSpec
from madsim_tpu.explore import targets as rtargets

import _torch_mesh_jobs as jobs
from _torch_parity import ref_mesh, reference_curve, worlds

world = pytest.fixture(scope="module")(worlds)

CCFG = dict(rounds=2, seeds_per_round=256, chunk_size=128)


def ref_target():
    return rtargets.amnesia_raft_target(**jobs.AMNESIA)


@pytest.fixture(scope="module")
def ref_report(tmp_path_factory):
    """The reference campaign's report bytes (run once, unsharded)."""
    path = str(tmp_path_factory.mktemp("ref_campaign") / "ref.jsonl")
    rexplore.run_campaign(ref_target(), RSpec(**jobs.AMNESIA_BASE),
                          rexplore.CampaignConfig(**CCFG), report_path=path)
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def one_rank(world, tmp_path_factory):
    """The port's campaign on 1 rank, checkpointed: (report bytes, the
    checkpoint directory)."""
    tmp = tmp_path_factory.mktemp("one_rank")
    ckpt = str(tmp / "ckpt")
    return world(1, jobs.campaign, CCFG, str(tmp / "c1.jsonl"), ckpt), ckpt


def test_campaign_report_one_rank(one_rank, ref_report):
    got, ckpt = one_rank
    assert got == ref_report
    assert any(json.loads(line).get("violating_seeds") for line in got.splitlines()[1:])
    for r in range(CCFG["rounds"]):
        files = os.listdir(os.path.join(ckpt, f"round_{r:04d}"))
        assert files and not any(f.endswith(".tmp") for f in files)


def test_sharded_campaign_two_ranks_resumes_one_rank_checkpoint(world, one_rank, ref_report,
                                                                tmp_path):
    """``sharded_campaign`` on 2 ranks, resuming the 1-rank campaign's
    checkpoint with its last round's chunk files dropped (chunk files
    carry no mesh identity): the report equals the reference's byte for
    byte, and its metrics agree with the report."""
    import hashlib

    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(one_rank[1], ckpt)
    shutil.rmtree(os.path.join(ckpt, f"round_{CCFG['rounds'] - 1:04d}"))
    path = str(tmp_path / "c2.jsonl")
    metrics = world(2, jobs.campaign_metrics, 2, CCFG, path, ckpt)
    with open(path, "rb") as f:
        assert f.read() == ref_report
    assert metrics["report_sha256"] == hashlib.sha256(ref_report).hexdigest()
    records = [json.loads(line) for line in ref_report.splitlines()[1:]]
    assert metrics["rounds"] == len(records) == CCFG["rounds"]
    assert metrics["violations_total"] == sum(r["violations"] for r in records)
    assert metrics["events_total"] == sum(r["events_total"] for r in records)


def test_checked_sweep_curve_report_hashes(world):
    """``checked_sweep_curve`` over world sizes 1 and 2: each size's
    report hash equals the reference's on 1 and 2 devices, and so does
    its byte-invariance verdict."""
    import jax

    ref_mesh(2)
    want = rexplore.checked_sweep_curve(
        *rtargets.amnesia_gate(smoke=True), device_counts=(1, 2), seeds_total=64,
        chunk_per_device=32, devices=jax.devices("cpu")[:2])
    got = world(2, jobs.curve, (1, 2), 64, 32)
    assert [p["report_sha256"] for p in got["curve"]] == \
        [p["report_sha256"] for p in want["curve"]]
    assert got["bytes_invariant"] == want["bytes_invariant"]
    assert [p["violations"] for p in got["curve"]] == [p["violations"] for p in want["curve"]]


def test_checked_sweep_curve_follows_the_reference_where_hist_unique_moves(world):
    """At 128 seeds and 64 lanes per rank the reference's own curve is not
    byte-invariant: one history repeats across world size 1's two chunks,
    so its per-chunk ``hist_unique`` differs from world size 2's single
    chunk. The port's report hash equals the reference's at each size,
    and only ``hist_unique`` differs between them."""
    want = reference_curve(128, 64)
    assert not want["bytes_invariant"]
    assert want["hist_unique"]["1"] != want["hist_unique"]["2"]
    got = world(2, jobs.curve, (1, 2), 128, 64)
    assert {str(p["devices"]): p["report_sha256"] for p in got["curve"]} == want["report_sha256"]
    assert not got["bytes_invariant"] and got["invariant_but_hist_unique"]
