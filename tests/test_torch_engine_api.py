"""Port parity: the engine package's public names
(``madsim_tpu_torch.engine``, the reference's ``__all__``, and
``step_one``).

``engine.step_one`` advances one seed's state (no batch axis) by one
event, as the reference's ``core.step_one`` does: on the probe workload
(raft-shaped: 58 queue slots, 8 payload words, a ring write per event) a
lane stepped one event at a time by each package's ``step_one`` has every
leaf equal every ``CHECK_EVERY`` steps; on the tiny flagship, each lane
stepped by the port's ``step_one`` equals that lane of its
``step_batch``, which the raft parity tests hold to the reference.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

import __graft_entry__
from madsim_tpu.engine import core as rcore
from madsim_tpu.engine import megakernel as rmk
from madsim_tpu_torch import engine
from madsim_tpu_torch.engine import megakernel as pmk
from madsim_tpu_torch.engine import state_io, tree
from madsim_tpu_torch.models import raft as praft

from _torch_parity import assert_leaves_equal, port_cfg, port_ecfg, ref_leaves

SEEDS = (3, 11)
STEPS = 40
CHECK_EVERY = 10


def _lane(state, i):
    return tree.map(lambda a: a[i], state)


def test_the_engine_names_drive_a_sweep():
    _wl, cfg, ecfg = __graft_entry__._flagship(tiny=True)
    wl, pecfg = praft.workload(port_cfg(cfg)), port_ecfg(ecfg)
    assert isinstance(pecfg, engine.EngineConfig) and isinstance(wl, engine.Workload)
    state = engine.init_sweep(wl, pecfg, np.arange(4), device="cpu")
    assert isinstance(state, engine.EngineState)
    assert isinstance(state.queue, engine.EventQueue)
    final = engine.run_sweep(wl, pecfg, np.arange(4), device="cpu")
    assert bool(final.done.all())


def test_step_one_is_the_reference_step_one():
    rwl, rcfg = rmk.probe_workload(), rmk.probe_config(max_steps=STEPS)
    pwl, pcfg = pmk.probe_workload(), pmk.probe_config(max_steps=STEPS)
    rstep = jax.jit(partial(rcore.step_one, rwl, rcfg))
    ref0 = rcore.init_sweep(rwl, rcfg, jnp.asarray(SEEDS))
    port0 = engine.init_sweep(pwl, pcfg, list(SEEDS), device="cpu")
    for lane, seed in enumerate(SEEDS):
        rs, ps = jax.tree.map(lambda a: a[lane], ref0), _lane(port0, lane)
        for step in range(STEPS):
            rs, ps = rstep(rs), engine.step_one(pwl, pcfg, ps)
            if (step + 1) % CHECK_EVERY == 0:
                assert_leaves_equal(ref_leaves(rs), state_io.to_numpy_leaves(ps),
                                    f"seed {seed} step {step}")
        assert int(ps.ctr) == STEPS


def test_step_one_steps_a_lane_as_step_batch_does():
    _wl, cfg, ecfg = __graft_entry__._flagship(tiny=True)
    wl, pecfg = praft.workload(port_cfg(cfg)), port_ecfg(ecfg)
    batch = engine.init_sweep(wl, pecfg, list(SEEDS), device="cpu")
    lanes = [_lane(batch, i) for i in range(len(SEEDS))]
    for _ in range(STEPS):
        batch = engine.step_batch(wl, pecfg, batch, device="cpu")
        lanes = [engine.step_one(wl, pecfg, s) for s in lanes]
    for i, s in enumerate(lanes):
        assert_leaves_equal(state_io.to_numpy_leaves(_lane(batch, i)),
                            state_io.to_numpy_leaves(s), f"lane {i}")
        assert int(s.ctr) > 0
