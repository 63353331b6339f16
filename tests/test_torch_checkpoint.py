"""Port parity: sweep snapshots and the chunk drivers
(``madsim_tpu_torch.engine.checkpoint``) against
``madsim_tpu.engine.checkpoint`` — ``.npz`` snapshots written by either
package resume in the other to equal summaries (raft, and etcd with its
history plane), the v10 rule for files without the trailing event-mix
leaf, interrupted and restarted drivers (a ragged final chunk,
``pad_multiple``), mid-chunk resume from a snapshot the reference wrote,
and chunk directories of another sweep refused."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__
from madsim_tpu.engine import checkpoint as rckpt
from madsim_tpu.engine import core as rcore
from madsim_tpu.engine import faults as rfaults
from madsim_tpu.models import etcd as retcd
from madsim_tpu.models import raft as rraft
from madsim_tpu.oracle import screen as rscreen
from madsim_tpu_torch.engine import checkpoint as pckpt
from madsim_tpu_torch.engine import core as pcore
from madsim_tpu_torch.engine import faults as pfaults
from madsim_tpu_torch.engine import state_io
from madsim_tpu_torch.models import etcd as petcd
from madsim_tpu_torch.models import raft as praft
from madsim_tpu_torch.oracle import screen as pscreen

from _torch_parity import assert_leaves_equal, port_ecfg, ref_leaves
from _torch_parity import port_cfg as port_raft_cfg

MID_STEPS = 25


def _model(name):
    """(reference module, workload, engine config, port module, workload,
    engine config) of the raft or etcd case."""
    if name == "raft":
        _wl, cfg, ecfg = __graft_entry__._flagship(tiny=True)
        pcfg, mod_r, mod_p = port_raft_cfg(cfg), rraft, praft
    else:
        cfg = retcd.EtcdConfig(hist_slots=32)
        ecfg = retcd.engine_config(cfg, time_limit_ns=1_000_000_000)
        pcfg, mod_r, mod_p = petcd.EtcdConfig(**cfg._asdict()), retcd, petcd
    return mod_r, mod_r.workload(cfg), ecfg, mod_p, mod_p.workload(pcfg), port_ecfg(ecfg)


def _ref_mid(wl, ecfg, seeds):
    """A reference state after ``MID_STEPS`` steps of the sweep."""
    state = rcore.init_sweep(wl, ecfg, jnp.asarray(seeds))
    return rcore._drive(wl, ecfg._replace(max_steps=MID_STEPS), state)


def _port_mid(wl, ecfg, seeds):
    state = pcore.init_sweep(wl, ecfg, seeds, device="cpu")
    return pcore.drive(wl, ecfg._replace(max_steps=MID_STEPS), state)


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("model", ["raft", "etcd"])
def test_snapshots_cross_between_the_packages(model, tmp_path):
    mod_r, rwl, ecfg, mod_p, pwl, pecfg = _model(model)
    seeds = np.arange(12, dtype=np.int64)
    rmid, pmid = _ref_mid(rwl, ecfg, seeds), _port_mid(pwl, pecfg, seeds)
    assert_leaves_equal(ref_leaves(rmid), state_io.to_numpy_leaves(pmid), "mid-run")
    if model == "etcd":
        assert int(pmid.hist_len.sum()) > 0 and not bool(pmid.done.all())
    rpath, ppath = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    rckpt.save_sweep(rmid, rpath)
    pckpt.save_sweep(pmid, ppath)
    # the same bytes per array, names and dtypes (the key as uint32 words)
    rz, pz = _npz(rpath), _npz(ppath)
    assert sorted(pz) == sorted(rz) and "leaf_1__key" in pz
    for k in rz:
        assert rz[k].dtype == pz[k].dtype and (rz[k] == pz[k]).all(), k
    want = mod_r.sweep_summary(rckpt.resume_sweep(rwl, ecfg, rmid))

    # reference -> port
    like = pcore.init_sweep(pwl, pecfg, [0], device="cpu")
    loaded = pckpt.load_sweep(rpath, like)
    assert_leaves_equal(ref_leaves(rmid), state_io.to_numpy_leaves(loaded), "loaded")
    assert mod_p.sweep_summary(pckpt.resume_sweep(pwl, pecfg, loaded)) == want

    # port -> reference
    rlike = rcore.init_sweep(rwl, ecfg, jnp.arange(1, dtype=jnp.int64))
    rloaded = rckpt.load_sweep(ppath, rlike)
    assert mod_r.sweep_summary(rckpt.resume_sweep(rwl, ecfg, rloaded)) == want


def _without_evmix(src, dst, version):
    """``src`` as a file of format ``version`` without its last leaf."""
    z = _npz(src)
    last = max(int(k.split("_")[1]) for k in z if k.startswith("leaf_"))
    z.pop(f"leaf_{last}")
    z["__version__"] = np.asarray(version)
    np.savez_compressed(dst, **z)


def test_v10_rule_for_a_missing_trailing_leaf(tmp_path):
    _wl, cfg, ecfg = __graft_entry__._flagship(tiny=True)
    pecfg = port_ecfg(ecfg)
    seeds = np.arange(6, dtype=np.int64)
    state = _port_mid(praft.workload(port_raft_cfg(cfg)), pecfg, seeds)
    full, old = str(tmp_path / "v10.npz"), str(tmp_path / "v9.npz")
    pckpt.save_sweep(state, full)
    _without_evmix(full, old, 9)
    # the plane is off (width 0): the missing leaf is the like's own empty
    # one, so the like has the snapshot's lanes
    like = pcore.init_sweep(praft.workload(port_raft_cfg(cfg)), pecfg, seeds, device="cpu")
    loaded = pckpt.load_sweep(old, like)
    assert state_io.first_difference(loaded, state) is None
    rlike = rcore.init_sweep(rraft.workload(cfg), ecfg, jnp.asarray(seeds))
    assert_leaves_equal(ref_leaves(rckpt.load_sweep(old, rlike)),
                        state_io.to_numpy_leaves(state), "reference load")
    # the plane is on: refused in both packages
    on = cfg._replace(event_mix=True)
    like_on = pcore.init_sweep(praft.workload(port_raft_cfg(on)), pecfg, [0], device="cpu")
    with pytest.raises(ValueError, match="pre-v10"):
        pckpt.load_sweep(old, like_on)
    with pytest.raises(ValueError, match="pre-v10"):
        rckpt.load_sweep(old, rcore.init_sweep(rraft.workload(on), ecfg,
                                               jnp.arange(1, dtype=jnp.int64)))
    _without_evmix(full, str(tmp_path / "v5.npz"), 5)
    with pytest.raises(ValueError, match="version mismatch"):
        pckpt.load_sweep(str(tmp_path / "v5.npz"), like)


def test_inflight_and_mesh_metadata_round_trip(tmp_path):
    _wl, cfg, ecfg = __graft_entry__._flagship(tiny=True)
    state = pcore.init_sweep(praft.workload(port_raft_cfg(cfg)), port_ecfg(ecfg), [3, 4],
                             device="cpu")
    path = str(tmp_path / "s.npz")
    pckpt.save_sweep(state, path, inflight={"lo": 16, "k": 2}, mesh_layout={"devices": 2})
    assert pckpt.load_inflight(path) == rckpt.load_inflight(path) == {"lo": 16, "k": 2}
    assert pckpt.load_mesh_layout(path) == rckpt.load_mesh_layout(path) == {"devices": 2}
    pckpt.save_sweep(state, path)
    assert pckpt.load_inflight(path) is None and pckpt.load_mesh_layout(path) is None


SEEDS = np.arange(40, dtype=np.int64)
CHUNK = 16


@pytest.fixture(scope="module")
def etcd_pipeline():
    """The etcd history model, the reference's straight checked totals
    (40 seeds, chunks of 16: the last chunk ragged) and a maker of the
    port's host work and screen."""
    mod_r, rwl, ecfg, mod_p, pwl, pecfg = _model("etcd")
    spec_r, spec_p = retcd.history_spec(), petcd.history_spec()
    want = rckpt.run_sweep_pipelined(
        rwl, ecfg, SEEDS, retcd.sweep_summary, chunk_size=CHUNK,
        host_work=rscreen.history_host_work(spec_r),
        screen=lambda f: rscreen.screen_sweep(f, spec_r),
    )

    def checked():
        return {"host_work": pscreen.history_host_work(spec_p),
                "screen": lambda f: pscreen.screen_sweep(f, spec_p)}

    return rwl, ecfg, pwl, pecfg, want, checked


def test_pipelined_straight_and_interrupted_equal_the_reference(etcd_pipeline, tmp_path):
    _rwl, _ecfg, pwl, pecfg, want, checked = etcd_pipeline
    straight = pckpt.run_sweep_pipelined(pwl, pecfg, SEEDS, petcd.sweep_summary,
                                         chunk_size=CHUNK, device="cpu", **checked())
    assert json.dumps(straight, sort_keys=True) == json.dumps(want, sort_keys=True)
    ckpt = str(tmp_path / "p")
    chunks = []
    first = pckpt.run_sweep_pipelined(
        pwl, pecfg, SEEDS, petcd.sweep_summary, chunk_size=CHUNK, ckpt_dir=ckpt,
        stop_after=1, device="cpu", on_chunk=lambda **kw: chunks.append(kw["lo"]), **checked())
    assert chunks == [0] and first["seeds"] == CHUNK
    assert sorted(os.listdir(ckpt)) == ["pchunk_0000000000_16.json"]
    rest = pckpt.run_sweep_pipelined(
        pwl, pecfg, SEEDS, petcd.sweep_summary, chunk_size=CHUNK, ckpt_dir=ckpt,
        device="cpu", on_chunk=lambda **kw: chunks.append(kw["lo"]), **checked())
    assert chunks == [0, 0, 16, 32]
    assert json.dumps(rest, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_mid_chunk_resume_from_a_reference_snapshot(etcd_pipeline, tmp_path):
    """The reference saves the in-flight chunks at 16 and at 32 (the ragged
    one, padded with its synthetic seeds) mid-run; the port finishes each
    from the file to the straight run's totals."""
    rwl, ecfg, pwl, pecfg, want, checked = etcd_pipeline
    like = pcore.init_sweep(pwl, pecfg, [0], device="cpu")
    for lo in (16, 32):
        k = min(CHUNK, len(SEEDS) - lo)
        chunk = rcore._pad_seeds(jnp.asarray(SEEDS[lo:lo + k]), CHUNK - k) if k < CHUNK \
            else SEEDS[lo:lo + k]
        path = str(tmp_path / f"inflight_{lo}.npz")
        rckpt.save_sweep(_ref_mid(rwl, ecfg, chunk), path, inflight={"lo": lo, "k": k})
        snap = (pckpt.load_sweep(path, like), pckpt.load_inflight(path))
        got = pckpt.run_sweep_pipelined(pwl, pecfg, SEEDS, petcd.sweep_summary,
                                        chunk_size=CHUNK, resume_from=snap, device="cpu",
                                        **checked())
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    bad = (snap[0], {"lo": 32, "k": 3})
    with pytest.raises(ValueError, match="does not match"):
        pckpt.run_sweep_pipelined(pwl, pecfg, SEEDS, petcd.sweep_summary, chunk_size=CHUNK,
                                  resume_from=bad, device="cpu")


@pytest.mark.parametrize("n,chunk,multiple", [(10, 16, 4), (40, 16, 1)],
                         ids=["pad_multiple", "ragged_tail"])
def test_pipelined_padding_equals_the_reference(n, chunk, multiple):
    _wl, cfg, ecfg = __graft_entry__._flagship(tiny=True)
    seeds = np.arange(100, 100 + n, dtype=np.int64)
    want = rckpt.run_sweep_pipelined(rraft.workload(cfg), ecfg, seeds, rraft.sweep_summary,
                                     chunk_size=chunk, pad_multiple=multiple)
    seen = []

    def host_work(final, *, lo, n, seeds, suspect, summary):
        seen.append((lo, n, final.seed.tolist(), seeds.tolist()))
        return {}

    got = pckpt.run_sweep_pipelined(praft.workload(port_raft_cfg(cfg)), port_ecfg(ecfg), seeds,
                                    praft.sweep_summary, chunk_size=chunk,
                                    pad_multiple=multiple, host_work=host_work, device="cpu")
    assert got == want
    # the host phase sees exactly the real lanes
    assert [s for _, _, s, _ in seen] == [s for _, _, _, s in seen]
    assert sum(k for _, k, _, _ in seen) == n


def test_chunked_resumable_interrupted_equals_the_reference(tmp_path):
    mod_r, rwl, ecfg, mod_p, pwl, pecfg = _model("etcd")
    want = rckpt.run_sweep_chunked_resumable(rwl, ecfg, SEEDS, retcd.sweep_summary,
                                             str(tmp_path / "r"), chunk_size=CHUNK)
    ckpt = str(tmp_path / "p")
    got = pckpt.run_sweep_chunked_resumable(pwl, pecfg, SEEDS, petcd.sweep_summary, ckpt,
                                            chunk_size=CHUNK, device="cpu")
    assert got == want
    assert sorted(os.listdir(ckpt)) == [
        "chunk_0000000000_16.json", "chunk_0000000016_16.json", "chunk_0000000032_8.json"]
    # an interruption lost the middle chunk's file: the restart recomputes it
    os.remove(os.path.join(ckpt, "chunk_0000000016_16.json"))
    again = pckpt.run_sweep_chunked_resumable(pwl, pecfg, SEEDS, petcd.sweep_summary, ckpt,
                                              chunk_size=CHUNK, device="cpu")
    assert again == want and len(os.listdir(ckpt)) == 3
    # the totals of the whole sweep in one run
    assert got == petcd.sweep_summary(
        pcore.run_sweep(pwl, pecfg, SEEDS, device="cpu"))


def test_foreign_chunk_directories_are_refused(tmp_path):
    mod_r, rwl, ecfg, mod_p, pwl, pecfg = _model("etcd")
    seeds = SEEDS[:20]
    ref_dir, port_dir = str(tmp_path / "r"), str(tmp_path / "p")
    rckpt.run_sweep_chunked_resumable(rwl, ecfg, seeds, retcd.sweep_summary, ref_dir,
                                      chunk_size=CHUNK)
    rckpt.run_sweep_pipelined(rwl, ecfg, seeds, retcd.sweep_summary, chunk_size=CHUNK,
                              ckpt_dir=ref_dir)
    # the reference's files name its own module in the fingerprint
    with pytest.raises(ValueError, match="different sweep"):
        pckpt.run_sweep_chunked_resumable(pwl, pecfg, seeds, petcd.sweep_summary, ref_dir,
                                          chunk_size=CHUNK, device="cpu")
    with pytest.raises(ValueError, match="different sweep"):
        pckpt.run_sweep_pipelined(pwl, pecfg, seeds, petcd.sweep_summary, chunk_size=CHUNK,
                                  ckpt_dir=ref_dir, device="cpu")
    # the port's own files of other seeds: the seed sha and endpoints
    pckpt.run_sweep_chunked_resumable(pwl, pecfg, seeds, petcd.sweep_summary, port_dir,
                                      chunk_size=CHUNK, device="cpu")
    with pytest.raises(ValueError, match="different sweep"):
        pckpt.run_sweep_chunked_resumable(pwl, pecfg, seeds + 1000, petcd.sweep_summary,
                                          port_dir, chunk_size=CHUNK, device="cpu")
    shuffled = seeds.copy()
    shuffled[3], shuffled[5] = shuffled[5], shuffled[3]
    with pytest.raises(ValueError, match="different sweep"):
        pckpt.run_sweep_chunked_resumable(pwl, pecfg, shuffled, petcd.sweep_summary,
                                          port_dir, chunk_size=CHUNK, device="cpu")


def test_fingerprint_names_the_port_module_and_params_digest_matches():
    mod_r, rwl, ecfg, mod_p, pwl, pecfg = _model("etcd")
    rfp, pfp = rckpt._sweep_fingerprint(rwl, ecfg), pckpt._sweep_fingerprint(pwl, pecfg)
    assert pfp.startswith("madsim_tpu_torch.models.etcd._init|")
    assert pfp != rfp
    assert pfp == rfp.replace("madsim_tpu.models.etcd", "madsim_tpu_torch.models.etcd")
    # layout-only engine fields do not change it
    assert pckpt._sweep_fingerprint(pwl, pecfg._replace(legacy_queue=1)) == pfp
    specs = [dict(crashes=2, partitions=1), dict(crashes=1)]
    renv = rfaults.campaign_envelope(*(rfaults.FaultSpec(**s) for s in specs))
    penv = pfaults.campaign_envelope(*(pfaults.FaultSpec(**s) for s in specs))
    for s in specs:
        rp = rfaults.spec_to_params(rfaults.FaultSpec(**s), renv, 3)
        pp = pfaults.spec_to_params(pfaults.FaultSpec(**s), penv, 3)
        assert pckpt.params_digest(pp) == rckpt.params_digest(rp)
