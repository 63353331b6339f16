"""Port parity: the history screens (``madsim_tpu_torch.oracle.screen``)
against ``madsim_tpu.oracle.screen`` — each screen, written here as one
function over a lane batch, against the reference's per-seed function
under ``vmap`` on the same planes: seeded random histories (paired
invokes and completions, then edited: DEL rows, unknown and negative
codes, re-invoked opids, tied times, overflowed lengths) and hand-built
ones (a key over the contention window, offset gaps in a log);
``screen_sweep`` over more lanes than one block with a ragged last
block; and zero-width planes."""

from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madsim_tpu.engine  # noqa: F401  (the reference's int64 mode, before its screens)
from madsim_tpu.oracle import history as rhist
from madsim_tpu.oracle import screen as rscreen
from madsim_tpu.oracle import specs as rspecs
from madsim_tpu_torch.oracle import screen as pscreen
from madsim_tpu_torch.oracle import specs as pspecs

KINDS = {
    "kv": (rhist.OP_PUT, rhist.OP_GET),
    "log": (rhist.OP_PRODUCE, rhist.OP_FETCH),
    "election": (rhist.OP_ELECT,),
}


def random_planes(seed: int, s: int, h: int, family: str):
    """``s`` lanes of up to ``h`` rows: clients invoke ops with fresh
    opids and complete pending ones later (some stay open), times step by
    0-2 (ties), then about a fifth of the lanes get one edited row."""
    rs = np.random.RandomState(seed)
    kinds = KINDS[family]
    rec = np.zeros((s, h, 5), np.int32)
    t = np.zeros((s, h), np.int64)
    n = np.zeros(s, np.int32)
    for lane in range(s):
        rows, pending, nxt, now = [], [], defaultdict(int), 0
        target = rs.randint(0, h + 1)
        while len(rows) < target:
            now += rs.randint(0, 3)
            if family != "election" and pending and rs.rand() < 0.5:
                client, opid, op, key, inp = pending.pop(rs.randint(len(pending)))
                if op == rhist.OP_GET:
                    out = rs.randint(-1, 5)
                elif op == rhist.OP_FETCH:
                    out = rs.randint(0, 3)
                else:
                    out = inp
                rows.append((client, op * 2 + 1, key, out, opid, now))
            else:
                client = rs.randint(3)
                opid = nxt[client]
                nxt[client] += 1
                op = kinds[rs.randint(len(kinds))]
                key = rs.randint(3)
                inp = rs.randint(0, 4) if op != rhist.OP_PUT else rs.randint(0, 12)
                pending.append((client, opid, op, key, inp))
                rows.append((client, op * 2, key, inp, opid, now))
        for i, row in enumerate(rows):
            rec[lane, i], t[lane, i] = row[:5], row[5]
        n[lane] = len(rows)
        if rows and rs.rand() < 0.2:
            i = rs.randint(len(rows))
            edit = rs.randint(4)
            if edit == 0:  # a DEL row, an unknown kind or a negative code
                rec[lane, i, 1] = rs.choice([4, 5, 12, 13, -1, -2])
            elif edit == 1:  # re-invoke an opid
                rec[lane, i, 4] = 0
            elif edit == 2:  # an orphan completion
                rec[lane, i, 1] |= 1
            else:  # the value column
                rec[lane, i, 3] = rs.randint(-1, 3)
    return rec, t, n


def _ref(fn, rec, t, n, **kw):
    f = (lambda a, b, c: fn(a, b, c, **kw)) if kw else fn
    return np.asarray(jax.vmap(f)(jnp.asarray(rec), jnp.asarray(t), jnp.asarray(n)))


def _port(fn, rec, t, n, **kw):
    out = fn(torch.from_numpy(rec), torch.from_numpy(t), torch.from_numpy(n), **kw)
    assert out.dtype == torch.bool and out.shape == (rec.shape[0],)
    return out.numpy()


SCREENS = [
    ("kv_window", "kv", "kv_window_suspect", {}),
    ("kv_window_2", "kv", "kv_window_suspect", {"window": 2}),
    ("kv_original", "kv", "kv_suspect", {}),
    ("log", "log", "log_suspect", {}),
    ("election", "election", "election_suspect", {}),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,family,fn,kw", SCREENS, ids=[s[0] for s in SCREENS])
def test_screen_equal_on_random_planes(name, family, fn, kw, seed):
    rec, t, n = random_planes(seed, 96, 14, family)
    want = _ref(getattr(rscreen, fn), rec, t, n, **kw)
    got = _port(getattr(pscreen, fn), rec, t, n, **kw)
    assert (got == want).all(), np.nonzero(got != want)[0]
    assert want.any() and not want.all()  # both verdicts occur


@pytest.mark.parametrize("name,family,fn,kw", SCREENS, ids=[s[0] for s in SCREENS])
def test_screen_equal_on_other_kinds_planes(name, family, fn, kw):
    """A screen fed another model's rows flags them as unscreenable."""
    other = {"kv": "log", "log": "election", "election": "kv"}[family]
    rec, t, n = random_planes(5, 24, 10, other)
    want = _ref(getattr(rscreen, fn), rec, t, n, **kw)
    assert (_port(getattr(pscreen, fn), rec, t, n, **kw) == want).all()


def _lane(rows, h):
    rec = np.zeros((1, h, 5), np.int32)
    t = np.zeros((1, h), np.int64)
    for i, (client, code, key, val, opid, when) in enumerate(rows):
        rec[0, i], t[0, i] = (client, code, key, val, opid), when
    return rec, t, np.array([len(rows)], np.int32)


def _put(op, ph):
    return rhist.code_of(op, ph)


def test_kv_key_over_the_contention_window():
    """34 concurrent open PUTs on one key: depth 34 > KV_WINDOW flags the
    lane; the same ops spread over 34 keys do not."""
    inv = _put(rhist.OP_PUT, rhist.PH_INVOKE)
    one_key = _lane([(c % 3, inv, 0, 100 + c, c, c) for c in range(34)], 40)
    many_keys = _lane([(c % 3, inv, c, 100 + c, c, c) for c in range(34)], 40)
    for rec, t, n in (one_key, many_keys):
        want = _ref(rscreen.kv_window_suspect, rec, t, n)
        assert (_port(pscreen.kv_window_suspect, rec, t, n) == want).all()
    assert _port(pscreen.kv_window_suspect, *one_key)[0]
    assert not _port(pscreen.kv_window_suspect, *many_keys)[0]


@pytest.mark.parametrize("second_offset,suspect", [(2, False), (3, True), (1, True)],
                         ids=["contiguous", "gap", "backwards"])
def test_log_offset_contiguity(second_offset, suspect):
    """Two produces, then one consumer's fetches at 0 (served 2) and at
    ``second_offset`` (served 0): only offset 2 continues the log."""
    pi, fi = _put(rhist.OP_PRODUCE, rhist.PH_INVOKE), _put(rhist.OP_FETCH, rhist.PH_INVOKE)
    po, fo = pi + 1, fi + 1
    rows = [(0, pi, 0, 1, 0, 1), (0, po, 0, 1, 0, 2), (0, pi, 0, 2, 1, 3), (0, po, 0, 2, 1, 4),
            (1, fi, 0, 0, 0, 5), (1, fo, 0, 2, 0, 6),
            (1, fi, 0, second_offset, 1, 7), (1, fo, 0, 0, 1, 8)]
    rec, t, n = _lane(rows, 10)
    want = _ref(rscreen.log_suspect, rec, t, n)
    assert (_port(pscreen.log_suspect, rec, t, n) == want).all()
    assert bool(want[0]) == suspect
    assert pscreen.screen_history(rec[0], t[0], n[0], pspecs.LogSpec(), device="cpu") == suspect


class Planes:
    def __init__(self, rec, t, n, as_tensor):
        self.hist_rec, self.hist_t, self.hist_len = (as_tensor(a) for a in (rec, t, n))
        self.seed = as_tensor(np.arange(len(n), dtype=np.int64))


@pytest.mark.parametrize("family,spec", [("kv", "KVSpec"), ("log", "LogSpec"),
                                         ("election", "ElectionSpec")])
def test_screen_sweep_in_blocks_with_a_ragged_tail(family, spec):
    rec, t, n = random_planes(7, 37, 12, family)
    want = np.asarray(rscreen.screen_sweep(Planes(rec, t, n, jnp.asarray),
                                           getattr(rspecs, spec)(), block=8))
    got = pscreen.screen_sweep(Planes(rec, t, n, torch.from_numpy),
                               getattr(pspecs, spec)(), block=8)
    assert got.dtype == torch.bool and (got.numpy() == want).all()
    one = pscreen.screen_sweep(Planes(rec, t, n, torch.from_numpy), getattr(pspecs, spec)())
    assert (one.numpy() == want).all()  # one block of 1,024 lanes
    for lane in (0, 9, 36):
        assert pscreen.screen_history(rec[lane], t[lane], n[lane], getattr(pspecs, spec)(),
                                      device="cpu") == (
            rscreen.screen_history(rec[lane], t[lane], n[lane], getattr(rspecs, spec)()))


def test_screen_history_runs_where_its_rows_are(monkeypatch):
    """Tensor rows are screened on their own device; numpy rows on
    ``device``, whose default is CUDA and raises without a card."""
    rec, t, n = random_planes(11, 4, 12, "kv")
    seen = []
    screen = pscreen._SCREENS["kv"]

    def spy(r, tt, nn):
        seen.append((r.device, tt.device, nn.device))
        return screen(r, tt, nn)

    monkeypatch.setitem(pscreen._SCREENS, "kv", spy)
    for lane in range(4):
        want = rscreen.screen_history(rec[lane], t[lane], n[lane], rspecs.KVSpec())
        got = pscreen.screen_history(torch.from_numpy(rec[lane]), torch.from_numpy(t[lane]),
                                     n[lane], pspecs.KVSpec())
        assert got == want
    assert seen == [(torch.device("cpu"),) * 3] * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        pscreen.screen_history(rec[0], t[0], n[0], pspecs.KVSpec())


def test_zero_width_planes_are_all_clean():
    planes = Planes(np.zeros((5, 0, 5), np.int32), np.zeros((5, 0), np.int64),
                    np.zeros(5, np.int32), torch.from_numpy)
    got = pscreen.screen_sweep(planes, pspecs.KVSpec())
    assert got.dtype == torch.bool and got.shape == (5,) and not got.any()


def test_screen_for_and_refusals():
    assert pscreen.screen_for(pspecs.KVSpec()) is pscreen.kv_window_suspect
    assert pscreen.screen_for(pspecs.S3Spec()) is None
    planes = Planes(np.zeros((2, 3, 5), np.int32), np.zeros((2, 3), np.int64),
                    np.zeros(2, np.int32), torch.from_numpy)
    with pytest.raises(ValueError, match="no device screen"):
        pscreen.screen_sweep(planes, pspecs.S3Spec())
    # mesh=: a one-rank mesh screens like no mesh; a mesh whose size does
    # not divide the lanes is refused (tests/test_torch_mesh.py runs the
    # multi-rank screens)
    from madsim_tpu_torch.parallel import SeedMesh, seed_mesh

    assert torch.equal(pscreen.screen_sweep(planes, pspecs.KVSpec(), mesh=seed_mesh(device="cpu")),
                       pscreen.screen_sweep(planes, pspecs.KVSpec()))
    with pytest.raises(ValueError, match="divide"):
        pscreen.screen_sweep(planes, pspecs.KVSpec(),
                             mesh=SeedMesh(None, 0, 3, torch.device("cpu"), ""))
