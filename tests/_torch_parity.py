"""Shared helpers for the port's parity tests (tests/test_torch_*.py):
the reference's leaves as numpy (typed keys as their key data), exact
leaf comparison, and reference -> port config conversion."""

import jax
import jax.numpy as jnp
import numpy as np

from madsim_tpu.engine import faults as rfaults
from madsim_tpu_torch.engine import core as pcore
from madsim_tpu_torch.engine import faults as pfaults
from madsim_tpu_torch.models import raft as praft


def ref_leaves(state):
    """``jax.tree.leaves(state)`` as numpy; a typed PRNG key becomes its
    uint32 key data (the checkpoint format's ``leaf_{i}__key``)."""
    out = []
    for leaf in jax.tree.leaves(state):
        if jnp.issubdtype(leaf.dtype, jax.dtypes.prng_key):
            leaf = jax.random.key_data(leaf)
        out.append(np.asarray(leaf))
    return out


def assert_leaves_equal(ref, port, what="state"):
    """Exact equality of value, dtype and shape on every leaf."""
    assert len(ref) == len(port), f"{what}: {len(ref)} vs {len(port)} leaves"
    for i, (r, p) in enumerate(zip(ref, port)):
        r, p = np.asarray(r), np.asarray(p)
        assert r.dtype == p.dtype, f"{what} leaf {i}: dtype {r.dtype} vs {p.dtype}"
        assert r.shape == p.shape, f"{what} leaf {i}: shape {r.shape} vs {p.shape}"
        bad = np.argwhere(r != p)
        assert bad.size == 0, (
            f"{what} leaf {i}: {len(bad)} values differ, first at "
            f"{bad[0].tolist()}: {r[tuple(bad[0])]} vs {p[tuple(bad[0])]}"
        )


def port_spec(spec):
    """The port's FaultSpec, FixedFaults or FaultEnvelope with the
    reference one's fields."""
    if spec is None:
        return None
    return getattr(pfaults, type(spec).__name__)(**spec._asdict())


def port_cfg(cfg):
    """The port's RaftConfig with the reference config's fields."""
    d = cfg._asdict()
    d["faults"] = port_spec(d["faults"])
    return praft.RaftConfig(**d)


def port_ecfg(ecfg):
    return pcore.EngineConfig(**ecfg._asdict())


def same_spec_pair(**kw):
    """The same FaultSpec in both packages."""
    return rfaults.FaultSpec(**kw), pfaults.FaultSpec(**kw)
