"""Port parity: the checked sweep on real kafka histories — the
ordered-log screen (``log_suspect``), the canonical decode
(``canon_sweep``) and ``checked_sweep``'s report bytes, the port
(``device="cpu"``) against ``madsim_tpu``, for the clean
``KafkaConfig(hist_slots=...)`` and the ack-on-append bug with two
crashes; the histories' produce retries re-invoke one opid, and a small
``hist_slots`` overflows."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import madsim_tpu.engine  # noqa: F401  (the reference's int64 mode, before its screens)
from madsim_tpu.engine import core as rcore
from madsim_tpu.models import kafka as rkafka
from madsim_tpu.oracle import history as rhist
from madsim_tpu.oracle import screen as rscreen
from madsim_tpu_torch.engine import core as pcore
from madsim_tpu_torch.models import kafka as pkafka
from madsim_tpu_torch.oracle import history as phist
from madsim_tpu_torch.oracle import screen as pscreen

from _torch_parity import port_ecfg

SEEDS = np.arange(24, dtype=np.int64)
CHUNK = 16
HORIZON = 600_000_000


def _configs(bug, hist_slots):
    rcfg = rkafka.KafkaConfig(**chip_smoke.kafka_fields(bug, hist_slots))
    ecfg = rkafka.engine_config(rcfg, time_limit_ns=HORIZON, max_steps=20_000)
    return rcfg, ecfg, pkafka.KafkaConfig(**rcfg._asdict()), port_ecfg(ecfg)


@pytest.fixture(scope="module", params=[(False, 128), (True, 128), (True, 58)],
                ids=["clean", "ack_on_append", "overflow"])
def swept(request):
    bug, slots = request.param
    rcfg, ecfg, pcfg, pecfg = _configs(bug, slots)
    ref = rcore.run_sweep(rkafka.workload(rcfg), ecfg, jnp.asarray(SEEDS))
    port = pcore.run_sweep(pkafka.workload(pcfg), pecfg, SEEDS, device="cpu")
    return request.param, ref, port


def test_log_suspect_mask_equal(swept):
    (bug, slots), ref, port = swept
    want = np.asarray(rscreen.screen_sweep(ref, rkafka.history_spec()))
    got = pscreen.screen_sweep(port, pkafka.history_spec(), block=16)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(want, got.numpy())
    ov = port.hist_overflow.numpy()
    if slots == 58:
        assert ov.any() and not ov.all()
    else:
        assert not ov.any()


def test_histories_reinvoke_produce_opids(swept):
    """Produce retries: one (client, opid) invoked more than once."""
    _case, _ref, port = swept
    rec, n = port.hist_rec.numpy(), port.hist_len.numpy()
    retried = 0
    for lane in range(len(SEEDS)):
        rows = rec[lane, : n[lane]]
        inv = rows[rows[:, 1] == 6]  # produce invokes
        keys = list(zip(inv[:, 0].tolist(), inv[:, 4].tolist()))
        retried += len(keys) - len(set(keys))
    assert retried > 0


def test_canon_sweep_equal(swept):
    _case, ref, port = swept
    for what, r, p in zip(("canon", "n_ops", "breach"), rhist.canon_sweep(ref),
                          phist.canon_sweep(port, block=16)):
        r, p = np.asarray(r), p.numpy()
        assert r.dtype == p.dtype and r.shape == p.shape, what
        assert (r == p).all(), f"{what} differs"
    for lane in (0, 7, 23):
        assert phist.history_canonical_bytes(phist.decode_seed(port, lane)) == \
            rhist.history_canonical_bytes(rhist.decode_seed(ref, lane))


@pytest.mark.parametrize("bug,decode", [(False, False), (True, True)],
                         ids=["clean-host_decode", "ack_on_append-device_decode"])
def test_checked_sweep_report_bytes_equal(bug, decode):
    """Report bytes over 24 seeds in chunks of 16 (a ragged tail) against
    the reference's, through the host decoder and ``canon_sweep``."""
    rcfg, ecfg, pcfg, pecfg = _configs(bug, 128)
    want = rscreen.checked_sweep(
        rkafka.workload(rcfg), ecfg, SEEDS, rkafka.history_spec(), rkafka.sweep_summary,
        chunk_size=CHUNK,
    )
    got = pscreen.checked_sweep(
        pkafka.workload(pcfg), pecfg, SEEDS, pkafka.history_spec(), pkafka.sweep_summary,
        chunk_size=CHUNK, device_decode=decode, workers=2 if decode else 0, device="cpu",
    )
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["hist_screened"] == len(SEEDS) and got["hist_undecided"] == 0
    if bug:
        assert got["violations"] > 0
    else:
        assert got["violations"] == 0 and got["hist_violations"] == 0
