"""Port parity: the history decoders and the canonical decode
(``madsim_tpu_torch.oracle.history``) against ``madsim_tpu.oracle.history``
— per-lane decode and its byte encodings on etcd and raft sweeps,
``canon_sweep``'s three outputs with their dtypes (blocked and cut to the
longest history here, one vmapped program there), record-hook breaches,
tied times and ``HostRecorder``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.engine import core as rcore
from madsim_tpu.models import etcd as retcd
from madsim_tpu.models import raft as rraft
from madsim_tpu.oracle import history as rhist
from madsim_tpu_torch.engine import core as pcore
from madsim_tpu_torch.models import etcd as petcd
from madsim_tpu_torch.models import raft as praft
from madsim_tpu_torch.oracle import history as phist

from _torch_parity import port_cfg as port_raft_cfg
from _torch_parity import port_ecfg

SEEDS = np.arange(20, dtype=np.int64)


class Planes:
    """A stand-in sweep state holding just the history planes."""

    def __init__(self, rec, t, n, overflow=None, seed=None):
        s = len(n)
        self.hist_rec, self.hist_t, self.hist_len = rec, t, n
        self.hist_overflow = np.zeros(s, bool) if overflow is None else overflow
        self.seed = np.arange(s, dtype=np.int64) if seed is None else seed

    def as_ref(self):
        return Planes(*(jnp.asarray(a) for a in (
            self.hist_rec, self.hist_t, self.hist_len, self.hist_overflow, self.seed)))

    def as_port(self):
        return Planes(*(torch.from_numpy(np.array(a)) for a in (
            self.hist_rec, self.hist_t, self.hist_len, self.hist_overflow, self.seed)))


def _sweeps(model):
    if model == "etcd":
        rcfg = retcd.EtcdConfig(bug_stale_read=True, hist_slots=16)
        ecfg = retcd.engine_config(rcfg, time_limit_ns=1_000_000_000)
        ref = rcore.run_sweep(retcd.workload(rcfg), ecfg, jnp.asarray(SEEDS))
        pcfg = petcd.EtcdConfig(**rcfg._asdict())
        port = pcore.run_sweep(petcd.workload(pcfg), port_ecfg(ecfg), SEEDS, device="cpu")
    else:
        rcfg = rraft.RaftConfig(num_nodes=3, crashes=1, hist_slots=6)
        ecfg = rraft.engine_config(rcfg, time_limit_ns=1_500_000_000)
        ref = rcore.run_sweep(rraft.workload(rcfg), ecfg, jnp.asarray(SEEDS))
        port = pcore.run_sweep(
            praft.workload(port_raft_cfg(rcfg)), port_ecfg(ecfg), SEEDS, device="cpu"
        )
    return ref, port


@pytest.fixture(scope="module", params=["etcd", "raft"])
def swept(request):
    return request.param, *_sweeps(request.param)


def test_decode_and_encodings_equal(swept):
    model, ref, port = swept
    for lane in range(len(SEEDS)):
        r, p = rhist.decode_seed(ref, lane), phist.decode_seed(port, lane)
        assert tuple(p) == tuple(r)
        assert phist.history_bytes(p) == rhist.history_bytes(r)
        assert phist.history_canonical_bytes(p) == rhist.history_canonical_bytes(r)
    hists = phist.decode_sweep(port)
    assert sum(len(h.ops) for h in hists) >= len(SEEDS)
    if model == "etcd":
        # some seed overflows its 16 rows, and then decodes its prefix
        assert any(h.overflow for h in hists) and not all(h.overflow for h in hists)


@pytest.mark.parametrize("lanes", [[3], [0, 7, 19, 2], list(range(19, -1, -1))],
                         ids=["one", "sparse", "all_reversed"])
def test_decode_lanes_equal(swept, lanes):
    _model, ref, port = swept
    assert [tuple(h) for h in phist.decode_lanes(port, lanes)] == [
        tuple(h) for h in rhist.decode_lanes(ref, lanes)
    ]


def _assert_canon_equal(ref_out, port_out):
    for what, r, p in zip(("canon", "n_ops", "breach"), ref_out, port_out):
        r, p = np.asarray(r), p.numpy()
        assert r.dtype == p.dtype, f"{what}: dtype {r.dtype} vs {p.dtype}"
        assert r.shape == p.shape, f"{what}: shape {r.shape} vs {p.shape}"
        assert (r == p).all(), f"{what} differs"


@pytest.mark.parametrize("block", [1024, 7])
def test_canon_sweep_equal(swept, block):
    _model, ref, port = swept
    out = phist.canon_sweep(port, block=block)
    _assert_canon_equal(rhist.canon_sweep(ref), out)
    canon, n_ops, _ = out
    for lane in range(len(SEEDS)):
        want = phist.history_canonical_bytes(phist.decode_seed(port, lane))
        got = phist.canonical_bytes_from_rows(
            canon[lane].numpy(), n_ops[lane], port.hist_len[lane], port.hist_overflow[lane])
        assert got == want


def _edited_planes(rs, s, h):
    """Random invoke/ok rows with reused opids and tied times."""
    rec = np.zeros((s, h, 5), np.int32)
    rec[:, :, 0] = rs.randint(0, 2, (s, h))
    rec[:, :, 1] = rs.randint(0, 4, (s, h))  # put/get, invoke/ok
    rec[:, :, 2] = rs.randint(0, 3, (s, h))
    rec[:, :, 3] = rs.randint(-1, 4, (s, h))
    rec[:, :, 4] = rs.randint(0, 3, (s, h))
    t = np.sort(rs.randint(0, h // 2, (s, h)), axis=1).astype(np.int64)
    n = rs.randint(0, h + 1, s).astype(np.int32)
    return rec, t, n


def test_canon_sweep_equal_on_edited_planes():
    """Hand-edited planes: orphan ok rows and op/key mismatches (breach),
    re-invoked opids and tied times, ragged lengths, blocks of 5."""
    rs = np.random.RandomState(11)
    planes = Planes(*_edited_planes(rs, 23, 12))
    out = phist.canon_sweep(planes.as_port(), block=5)
    _assert_canon_equal(rhist.canon_sweep(planes.as_ref()), out)
    breach = out[2].numpy()
    assert breach.any() and not breach.all()
    for lane in range(23):
        rerr = perr = None
        try:
            want = rhist.decode_seed(planes, lane)
        except ValueError as e:
            rerr = str(e)
        try:
            got = phist.decode_seed(planes.as_port(), lane)
        except ValueError as e:
            perr = str(e)
        assert perr == rerr
        assert (perr is not None) == bool(breach[lane])
        if perr is None:
            assert tuple(got) == tuple(want)
            assert phist.history_canonical_bytes(got) == rhist.history_canonical_bytes(want)


@pytest.mark.parametrize("edit", ["orphan_ok", "op_mismatch", "key_mismatch"])
def test_breach_is_flagged_and_the_host_decoder_raises(edit):
    rec = np.zeros((1, 4, 5), np.int32)
    rec[0, 0] = (0, rhist.code_of(rhist.OP_PUT, rhist.PH_INVOKE), 3, 7, 0)
    rec[0, 1] = (0, rhist.code_of(rhist.OP_PUT, rhist.PH_OK), 3, 7, 0)
    if edit == "orphan_ok":
        rec[0, 1, 4] = 5
    elif edit == "op_mismatch":
        rec[0, 1, 1] = rhist.code_of(rhist.OP_GET, rhist.PH_OK)
    else:
        rec[0, 1, 2] = 4
    planes = Planes(rec, np.array([[10, 20, 0, 0]], np.int64), np.array([2], np.int32))
    _assert_canon_equal(rhist.canon_sweep(planes.as_ref()), phist.canon_sweep(planes.as_port()))
    assert bool(phist.canon_sweep(planes.as_port())[2][0])
    with pytest.raises(ValueError, match="no recorded invoke|mismatched"):
        phist.decode_seed(planes.as_port(), 0)


def test_zero_width_planes():
    planes = Planes(np.zeros((3, 0, 5), np.int32), np.zeros((3, 0), np.int64),
                    np.zeros(3, np.int32))
    canon, n_ops, breach = phist.canon_sweep(planes.as_port())
    assert canon.shape == (3, 0, 8) and n_ops.dtype == torch.int64
    assert not breach.any() and not n_ops.any()
    assert [len(h.ops) for h in phist.decode_sweep(planes.as_port())] == [0, 0, 0]


def test_history_from_canon_round_trips():
    rs = np.random.RandomState(3)
    planes = Planes(*_edited_planes(rs, 30, 10))
    canon, n_ops, breach = (a.numpy() for a in phist.canon_sweep(planes.as_port()))
    for lane in np.nonzero(~breach)[0]:
        h = phist.history_from_canon(canon[lane], n_ops[lane], False, planes.hist_len[lane])
        r = rhist.history_from_canon(canon[lane], n_ops[lane], False, planes.hist_len[lane])
        assert tuple(h) == tuple(r)
        assert phist.canonical_rows(h).tolist() == canon[lane][: n_ops[lane]].tolist()


def test_host_recorder_histories_equal():
    def record(mod):
        clock = iter([5, 9, 9, 14, 20, 31, 40]).__next__
        rec = mod.HostRecorder(clock=clock)
        a = rec.invoke(client=0, op=mod.OP_PUT, key=3, inp=42)
        b = rec.invoke(client=1, op=mod.OP_GET, key=3, inp=0)
        rec.complete(client=0, opid=a, out=42)
        c = rec.invoke(client=0, op=mod.OP_GET, key=4, inp=0)
        rec.complete(client=1, opid=b, out=42)
        rec.complete(client=0, opid=c, out=-1)
        with pytest.raises(ValueError, match="unknown or already-completed"):
            rec.complete(client=0, opid=a, out=1)
        return rec.history(seed=7)

    p, r = record(phist), record(rhist)
    assert tuple(p) == tuple(r)
    assert phist.history_bytes(p) == rhist.history_bytes(r)
    assert [o.describe() for o in p.ops] == [o.describe() for o in r.ops]
