"""Port parity: the fault-campaign compiler and interpreter.

Per-seed schedules (``schedule_events``), the compiled fault event
streams (``compile_device``) and the in-loop interpreter (``on_event``,
``skewed_delay``) of ``madsim_tpu_torch.engine.faults`` against
``madsim_tpu.engine.faults`` — exact equality of value, dtype and shape.
tests/test_faults.py is the template for the campaigns."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.engine import faults as rfaults
from madsim_tpu.engine import net as rnet
from madsim_tpu_torch.engine import faults as pfaults
from madsim_tpu_torch.engine import net as pnet
from madsim_tpu_torch.engine import rng as prng

from _torch_parity import assert_leaves_equal, ref_leaves, same_spec_pair

N = 5
SEEDS = np.concatenate([np.arange(40), [2**32 + 9, 2**40, -3]]).astype(np.int64)

SPECS = {
    # the flagship's crash storm (RaftConfig(num_nodes=5, crashes=1))
    "flagship_crash": dict(crashes=1),
    "crash_storm": dict(crashes=3, crash_window_ns=2_000_000_000,
                        restart_lo_ns=50_000_000, restart_hi_ns=300_000_000),
    "partitions": dict(partitions=3, part_group=(1, 4)),
    "loss_bursts": dict(losses=2, burst_loss_q32=3 << 30),
    "pauses": dict(pauses=2, pause_group=(0, 3)),
    "spikes": dict(spikes=2),
    "gray": dict(aparts=3, fsync_stalls=2, power_fails=2, skews=2,
                 skew_group=(2, -1)),
    "full": dict(crashes=2, crash_window_ns=1_500_000_000,
                 restart_lo_ns=100_000_000, restart_hi_ns=400_000_000,
                 partitions=2, part_window_ns=1_500_000_000,
                 part_lo_ns=200_000_000, part_hi_ns=600_000_000,
                 spikes=1, spike_window_ns=1_500_000_000,
                 losses=1, loss_window_ns=1_500_000_000,
                 pauses=1, pause_window_ns=1_500_000_000,
                 aparts=2, fsync_stalls=1, power_fails=1, skews=2),
}


def _ref_keys():
    return jax.vmap(jax.random.key)(jnp.asarray(SEEDS))


def _port_keys():
    return prng.seed_key(torch.from_numpy(SEEDS))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_schedule_events_match_reference(name):
    rspec, pspec = same_spec_pair(**SPECS[name])
    assert pfaults.num_events(pspec) == rfaults.num_events(rspec)
    ref = jax.vmap(lambda k: rfaults.schedule_events(rspec, N, k))(_ref_keys())
    port = pfaults.schedule_events(pspec, N, _port_keys())
    assert_leaves_equal(
        [np.asarray(a) for a in ref], [a.numpy() for a in port], f"schedule {name}"
    )


@pytest.mark.parametrize("name", ["flagship_crash", "partitions", "full"])
def test_compile_device_emits_match_reference(name):
    rspec, pspec = same_spec_pair(**SPECS[name])
    ref = jax.vmap(lambda k: rfaults.compile_device(rspec, N, k, 3, 8))(_ref_keys())
    port = pfaults.compile_device(pspec, N, _port_keys(), 3, 8)
    assert_leaves_equal(ref_leaves(ref), [a.numpy() for a in port], f"emits {name}")
    t = pfaults.decode_time(port.pays[:, :, 2], port.pays[:, :, 3])
    assert torch.equal(t, port.times)


def test_empty_spec_compiles_to_no_events():
    rspec, pspec = same_spec_pair()
    port = pfaults.compile_device(pspec, N, _port_keys(), 3, 8)
    assert port.times.shape == (len(SEEDS), 0)


@pytest.mark.parametrize("name", ["full", "gray", "loss_bursts"])
def test_on_event_over_a_traced_fault_stream(name):
    """Apply each seed's whole schedule, in time order, through both
    interpreters; links, fault state and edges agree after every event."""
    rspec, pspec = same_spec_pair(**SPECS[name])
    times, actions, victims = (
        np.asarray(a) for a in
        jax.vmap(lambda k: rfaults.schedule_events(rspec, N, k))(_ref_keys())
    )
    order = np.argsort(times, axis=1, kind="stable")
    actions = np.take_along_axis(actions, order, 1)
    victims = np.take_along_axis(victims, order, 1)
    s = len(SEEDS)
    base_r = rfaults.NetBase(1_000_000, 10_000_000, 42_949_673)
    base_p = pfaults.NetBase(*base_r)
    r_links = jax.vmap(lambda _: rnet.make(N, base_r.loss_q32, base_r.lat_lo_ns,
                                           base_r.lat_hi_ns))(jnp.arange(s))
    r_f = jax.vmap(lambda _: rfaults.init_state(N))(jnp.arange(s))
    p_links = pnet.make(s, N, base_p.loss_q32, base_p.lat_lo_ns, base_p.lat_hi_ns)
    p_f = pfaults.init_state(s, N)
    r_step = jax.jit(jax.vmap(
        lambda l, f, a, v: rfaults.on_event(rspec, base_r, l, f, a, v)))
    for j in range(actions.shape[1]):
        r_links, r_f, r_e = r_step(r_links, r_f, jnp.asarray(actions[:, j]),
                                   jnp.asarray(victims[:, j]))
        p_links, p_f, p_e = pfaults.on_event(
            pspec, base_p, p_links, p_f, torch.from_numpy(actions[:, j]),
            torch.from_numpy(victims[:, j]))
        assert_leaves_equal(
            ref_leaves((r_links, r_f, r_e)),
            [a.numpy() for a in (*p_links, *p_f, *p_e)],
            f"{name} event {j}",
        )
        # timers armed under the (possibly skewed) clock agree too
        node = victims[:, j]
        r_d = jax.vmap(lambda f, v: rfaults.skewed_delay(rspec, f, v, 50_000_000))(
            r_f, jnp.asarray(node))
        p_d = pfaults.skewed_delay(pspec, p_f, torch.from_numpy(node), 50_000_000)
        p_d = torch.as_tensor(p_d).expand(s)  # a python int for skew-free specs
        np.testing.assert_array_equal(np.asarray(r_d), p_d.numpy())
