"""Port parity: the crash-safe corpus/bug store and the lease protocol
(``madsim_tpu_torch.explore.store``) — the port's counterparts of the store
cases of ``tests/test_fleet.py``.

Every case runs the same writes through both packages' stores and holds
the port's log bytes, records, ``ReadStats``, quarantine lines and merged
view equal to the reference's; a store either package writes is read by
the other to the same ``merged()`` view. The lease cases run the port's
protocol as the reference's tests run it: expiry and reclaim, renewal,
done markers and no double grant between racing processes."""

import json
import multiprocessing as mp
import os
import time

import pytest

from madsim_tpu.explore import store as rstore
from madsim_tpu_torch.explore import store as pstore

import _torch_mesh_jobs as jobs

_P1 = {"fingerprint": "raft:f1:k2:n0", "seed": 7, "unit": 0}
_P2 = {"fingerprint": "raft:f1:k2:n0", "seed": 3, "unit": 2}
PKGS = {"reference": rstore, "port": pstore}


class Counts:
    """A telemetry stub: the store's ``count`` calls by name."""

    def __init__(self):
        self.counts = {}

    def count(self, name, n=1, help=None):
        del help
        self.counts[name] = self.counts.get(name, 0) + n


def _both(tmp_path, fn):
    """``fn(store module, root)`` under each package, in its own root;
    returns ``{package: result}``."""
    return {name: fn(mod, str(tmp_path / name)) for name, mod in PKGS.items()}


def _log_bytes(root, worker="w0"):
    with open(os.path.join(root, "log", f"{worker}.jsonl"), "rb") as f:
        return f.read()


# -- record layer -----------------------------------------------------------


def test_store_constants_and_encoding_equal_reference():
    assert (pstore.KIND_CAND, pstore.KIND_BUG) == (rstore.KIND_CAND, rstore.KIND_BUG)
    for payload in (_P1, _P2, {"b": [1, {"z": None, "a": True}], "a": "x"}, [3, "é"]):
        assert pstore.canonical_bytes(payload) == rstore.canonical_bytes(payload)
        assert pstore.payload_sha(payload) == rstore.payload_sha(payload)
    assert pstore.Lease._fields == rstore.Lease._fields
    assert pstore.ReadStats._fields == rstore.ReadStats._fields


def test_store_roundtrip_and_stats(tmp_path):
    def run(mod, root):
        st = mod.CorpusStore(root, worker="w0")
        st.append(mod.KIND_BUG, "fp-a", _P1)
        st.append(mod.KIND_CAND, "000000/00", {"unit": 0, "violations": 2})
        st.close()
        records, stats = mod.CorpusStore(root, worker="r").read_records()
        return _log_bytes(root), records, tuple(stats)

    out = _both(tmp_path, run)
    assert out["port"] == out["reference"]
    _, records, stats = out["port"]
    assert stats == (2, 0, 0)
    assert [r["kind"] for r in records] == [pstore.KIND_BUG, pstore.KIND_CAND]
    assert records[0]["payload"] == _P1 and records[0]["sha"] == pstore.payload_sha(_P1)


def test_merged_min_combine_is_partition_invariant(tmp_path):
    recs = [
        ("bug", "fp-a", _P2),
        ("bug", "fp-a", _P1),  # duplicate key: min canonical wins
        ("bug", "fp-b", {"fingerprint": "x", "seed": 1}),
        ("cand", "000000/00", {"unit": 0}),
    ]
    partitions = [[(0, 4)], [(0, 1), (1, 4)], [(0, 2), (2, 4)], [(0, 3), (0, 4)]]

    def run(mod, root):
        views = []
        for i, split in enumerate(partitions):
            sroot = os.path.join(root, f"s{i}")
            for wi, (lo, hi) in enumerate(split):
                w = mod.CorpusStore(sroot, worker=f"w{wi}")
                for kind, key, payload in recs[lo:hi]:
                    w.append(kind, key, payload)
                w.close()
            views.append(mod.CorpusStore(sroot, worker="r").merged())
        return views

    out = _both(tmp_path, run)
    assert out["port"] == out["reference"]
    views = out["port"]
    assert all(v == views[0] for v in views)
    assert views[0][("bug", "fp-a")] == _P2


@pytest.mark.parametrize("name", list(PKGS))
def test_store_torn_final_line_every_offset(tmp_path, name):
    """Every cut of the final line, in each package's log, reads alike in
    both packages: the valid prefix kept, a torn tail counted."""
    st = PKGS[name].CorpusStore(str(tmp_path), worker="w0")
    st.append("bug", "fp-a", _P1)
    st.append("bug", "fp-b", _P2)
    st.close()
    data = _log_bytes(str(tmp_path))
    last_start = data.rstrip(b"\n").rfind(b"\n") + 1
    for off in range(len(data) - last_start + 1):
        with open(st._log_path, "wb") as f:
            f.write(data[: last_start + off])
        got = {n: m.CorpusStore(str(tmp_path), worker="r").read_records() for n, m in PKGS.items()}
        assert got["port"][0] == got["reference"][0], off
        assert tuple(got["port"][1]) == tuple(got["reference"][1]), off
        records, stats = got["port"]
        whole = off >= len(data) - last_start - 1
        assert len(records) == (2 if whole else 1)
        assert stats.quarantined == 0
        assert stats.truncated_logs == (0 if whole or off == 0 else 1)


def test_bitflip_quarantined_with_counter(tmp_path):
    def run(mod, root):
        st = mod.CorpusStore(root, worker="w0")
        st.append("bug", "fp-a", _P1)
        st.append("bug", "fp-b", _P2)
        st.close()
        data = _log_bytes(root)
        i = data.index(b'"seed": 7')
        with open(st._log_path, "wb") as f:
            f.write(data[:i] + b'"seed": 8' + data[i + 9:])
        counts = Counts()
        reader = mod.CorpusStore(root, worker="r", telemetry=counts)
        records, stats = reader.read_records()
        qdir = os.path.join(root, "quarantine")
        (qfile,) = os.listdir(qdir)
        with open(os.path.join(qdir, qfile)) as f:
            quarantined = f.read()
        return records, tuple(stats), quarantined, reader.merged(), counts.counts

    out = _both(tmp_path, run)
    assert out["port"] == out["reference"]
    records, stats, quarantined, merged, counts = out["port"]
    assert stats == (1, 1, 0) and records[0]["payload"] == _P2
    (qrec,) = [json.loads(x) for x in quarantined.splitlines()]
    assert qrec["why"] == "sha mismatch" and '"seed": 8' in qrec["line"]
    assert merged == {("bug", "fp-b"): _P2}
    assert counts == {"fleet_store_quarantined_total": 2}  # read_records, then merged()


def test_malformed_interior_line_quarantined(tmp_path):
    def run(mod, root):
        st = mod.CorpusStore(root, worker="w0")
        st.append("bug", "fp-a", _P1)
        st.close()
        with open(st._log_path, "r+") as f:
            body = f.read()
            f.seek(0)
            f.write('{"kind": "bug", "key": "torn-by-a-dead\n' + body)
        records, stats = mod.CorpusStore(root, worker="r").read_records()
        return records, tuple(stats)

    out = _both(tmp_path, run)
    assert out["port"] == out["reference"]
    assert out["port"][1] == (1, 1, 0) and out["port"][0][0]["payload"] == _P1


def test_duplicate_fingerprint_from_concurrent_workers(tmp_path):
    def run(mod, root):
        views = []
        for a, b in ((_P1, _P2), (_P2, _P1)):
            sroot = os.path.join(root, f"o{a['seed']}")
            for w, p in (("w1", a), ("w2", b)):
                st = mod.CorpusStore(sroot, worker=w)
                st.append("bug", p["fingerprint"], p)
                st.close()
            views.append(mod.CorpusStore(sroot, worker="r").merged())
        return views

    out = _both(tmp_path, run)
    assert out["port"] == out["reference"]
    assert all(v == {("bug", _P1["fingerprint"]): _P2} for v in out["port"])


@pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference")])
def test_a_store_either_package_writes_the_other_reads(tmp_path, writer, reader):
    """Two workers of the writing package, a duplicate key, a torn final
    line and a flipped interior record: the reading package sees the same
    records, stats and merged view as the writer's own reader, and both
    packages write the same log bytes."""
    root = str(tmp_path / "store")
    w = PKGS[writer]
    for name, recs in (("w0", [("bug", "fp-a", _P1), ("cand", "000000/00", {"unit": 0})]),
                       ("w1", [("bug", "fp-a", _P2), ("cand", "000000/01", {"unit": 0})])):
        st = w.CorpusStore(root, worker=name)
        for rec in recs:
            st.append(*rec)
        st.close()
    with open(os.path.join(root, "log", "w1.jsonl"), "a") as f:
        f.write('{"kind": "bug", "key": "torn-')
    data = _log_bytes(root, "w0")
    i = data.index(b'"unit": 0')
    with open(os.path.join(root, "log", "w0.jsonl"), "wb") as f:
        f.write(data[:i] + b'"unit": 9' + data[i + 9:])
    theirs = PKGS[reader].CorpusStore(root, worker="reader")
    own = w.CorpusStore(root, worker="own")
    assert theirs.read_records()[0] == own.read_records()[0]
    assert tuple(theirs.read_records()[1]) == tuple(own.read_records()[1]) == (3, 1, 1)
    assert theirs.merged() == own.merged()
    assert theirs.merged()[("bug", "fp-a")] == _P2
    other = PKGS[reader].CorpusStore(str(tmp_path / "again"), worker="w0")
    other.append("bug", "fp-a", _P1)
    other.append("cand", "000000/00", {"unit": 0})
    other.close()
    assert _log_bytes(str(tmp_path / "again")) == data


# -- lease protocol (the port's) ----------------------------------------------


def test_lease_expiry_and_reclaim_after_worker_death(tmp_path):
    dead = pstore.CorpusStore(str(tmp_path), worker="dead", ttl_s=100)
    lease = dead.try_lease(3)
    assert lease is not None
    peer = pstore.CorpusStore(str(tmp_path), worker="peer", ttl_s=100)
    assert peer.try_lease(3) is None
    old = time.time() - 1000
    os.utime(lease.path, (old, old))
    counts = Counts()
    peer2 = pstore.CorpusStore(str(tmp_path), worker="peer2", ttl_s=100, telemetry=counts)
    re = peer2.try_lease(3)
    assert re is not None and re.worker == "peer2"
    assert counts.counts["fleet_lease_reclaimed_total"] == 1
    assert dead.renew(lease) is False


def test_heartbeat_renewal_keeps_slow_worker_alive(tmp_path):
    slow = pstore.CorpusStore(str(tmp_path), worker="slow", ttl_s=0.25)
    vulture = pstore.CorpusStore(str(tmp_path), worker="vulture", ttl_s=0.25)
    lease = slow.try_lease(0)
    assert lease is not None
    for _ in range(4):
        time.sleep(0.1)
        assert slow.renew(lease) is True
        assert vulture.try_lease(0) is None
    slow.mark_done(0)
    slow.release(lease)
    assert vulture.try_lease(0) is None


def test_done_unit_never_leased(tmp_path):
    st = pstore.CorpusStore(str(tmp_path), worker="w")
    lease = st.try_lease(1)
    st.mark_done(1)
    st.release(lease)
    assert st.is_done(1) and st.try_lease(1) is None
    assert st.next_lease(2) is not None
    st.mark_done(0)
    assert st.next_lease(2) is None and st.all_done(2)
    # the reference reads the port's done markers
    assert rstore.CorpusStore(str(tmp_path), worker="r").all_done(2)


def test_double_grant_impossible_under_racing_processes(tmp_path):
    ctx = mp.get_context("spawn")
    barrier = ctx.Barrier(2)
    q = ctx.Queue()
    procs = [ctx.Process(target=jobs.race_leases, args=(str(tmp_path), f"p{i}", barrier, q))
             for i in range(2)]
    for p in procs:
        p.start()
    results = dict(q.get(timeout=60) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    assert sorted(results["p0"] + results["p1"]) == [0, 1, 2, 3]
