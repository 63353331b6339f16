"""The plain reference holds to the port at tiny sizes on the CPU: the
same seeds give every leaf of the state equal after the same steps, and
equal history verdicts (the port's checker against the reference's)."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import sim

SEEDS = np.array([harness.seed_base(2**31 + 5, 2**32) + i for i in range(6)], dtype=np.int64)


def _config(name, **fields):
    with open(os.path.join(harness.PKG, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["fields"].update(fields)
    return cfg


def _port(cfg, steps):
    """The port on the CPU: each seed's leaves after ``steps`` steps (or
    at its end, where all lanes finish first)."""
    import importlib

    from madsim_tpu_torch.engine import core

    mod = importlib.import_module(f"madsim_tpu_torch.models.{cfg['model']}")
    wcfg = getattr(mod, cfg["config_class"])(**cfg["fields"])
    wl, ecfg = mod.workload(wcfg), mod.engine_config(wcfg, **cfg["engine"])
    state = core.init_sweep(wl, ecfg, SEEDS, device="cpu")
    for _ in range(steps):
        if bool(state.done.all()):
            break
        state = core.step_batch(wl, ecfg, state, device="cpu")
    leaves = sim.host_leaves(state)
    return state, [[leaf[i] for leaf in leaves] for i in range(len(SEEDS))]


def _equal(a, b):
    return all(x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("steps", [0, 1, 70])
def test_raft_state_equal_to_the_port(steps):
    cfg = _config("madraft-5n")
    _, port = _port(cfg, steps)
    ref = sim.simulate(cfg, SEEDS, [steps] * len(SEEDS))
    assert len(ref) == len(port)
    for p, r in zip(port, ref):
        assert len(p) == len(r) and _equal(p, r)


@pytest.mark.parametrize("stale", [False, True])
def test_etcd_state_and_verdicts_equal_to_the_port(stale):
    from madsim_tpu_torch.models import etcd
    from madsim_tpu_torch.oracle import check, history

    cfg = _config("etcd-lease-kv", bug_stale_read=stale)
    state, port = _port(cfg, 10**6)
    ref = sim.simulate(cfg, SEEDS, [10**6] * len(SEEDS))
    for p, r in zip(port, ref):
        assert _equal(p, r)
    spec = etcd.history_spec()
    port_ok = [check.check_history(h, spec, max_states=cfg["check"]["max_states"]).ok
               for h in history.decode_sweep(state)]
    assert sim.history_verdicts(cfg, ref) == port_ok
    if stale:
        assert not all(port_ok)  # the bug shows in some history


def test_uint32_leaves_are_compared_as_words():
    cfg = _config("madraft-5n")
    one = sim.template(cfg)
    dtypes = {str(a.dtype) for a in sim.tree.leaves(one)}
    assert "torch.uint32" in dtypes
    assert all(leaf.dtype != np.uint32 for leaf in sim.host_leaves(one))
    assert torch.equal(one.key.to(torch.int64)[0], torch.tensor([0, 0]))
