"""Shared helpers for the port's parity tests (tests/test_torch_*.py):
the reference's leaves as numpy (typed keys as their key data), exact
leaf comparison, reference -> port config conversion, and the host
tier's ``both()``: one program under both packages' ``Runtime(seed)``
with equal determinism logs, draw counts, virtual time and outputs."""

import datetime
import hashlib
import json
import os
import random
import time

import jax
import jax.numpy as jnp
import numpy as np

from _torch_shim_programs import record as run
from _torch_shim_programs import sub  # noqa: F401 (re-exported for the host tests)
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


def same_result(a, b, what):
    """Exact equality of two world jobs' results (arrays: dtype, shape
    and values; containers element by element)."""
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), what
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            same_result(x, y, what)
    else:
        assert a == b, what


def worlds():
    """The body of a module-scoped ``world`` fixture: ``world(n, job,
    *args)`` runs a job on the module's ``n``-rank gloo world of CPU ranks
    (``madsim_tpu_torch.parallel.World``, spawned on first use) and
    returns rank 0's result, every rank's being equal to it."""
    from madsim_tpu_torch.parallel import World

    spawned = {}

    def run(n, fn, *args):
        if n not in spawned:
            spawned[n] = World(n, device="cpu")
        out = spawned[n].run(fn, *args)
        for r, o in enumerate(out[1:], 1):
            same_result(o, out[0], f"rank {r} of {n} returned another result than rank 0")
        return out[0]

    yield run
    for w in spawned.values():
        w.close()


def ref_mesh(n):
    """The reference's seed mesh over ``n`` of the conftest's CPU devices."""
    import pytest

    from madsim_tpu import parallel as rparallel

    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"need {n} cpu devices (XLA_FLAGS force_host_platform_device_count)")
    return rparallel.seed_mesh(devs[:n])


def reference_curve(seeds: int, chunk_per_device: int, counts=(1, 2)) -> dict:
    """The reference's ``checked_sweep_curve`` of the smoke amnesia gate
    on as many CPU devices as each world size: per size its report
    sha256 and (from the unsharded sweep at the same global chunk, whose
    report hash must be the same) its ``hist_unique``, and its
    ``bytes_invariant``."""
    from madsim_tpu.explore import checked_sweep_curve
    from madsim_tpu.explore.targets import amnesia_gate
    from madsim_tpu.oracle.screen import checked_sweep

    target, base = amnesia_gate(smoke=True)
    curve = checked_sweep_curve(target, base, device_counts=counts, seeds_total=seeds,
                                chunk_per_device=chunk_per_device,
                                devices=jax.devices("cpu")[:max(counts)])
    workload, ecfg = target.build(base)
    shas, unique = {}, {}
    for p in curve["curve"]:
        n = p["devices"]
        totals = checked_sweep(workload, ecfg, np.arange(seeds, dtype=np.int64),
                               target.hist_spec, target.summarize,
                               chunk_size=chunk_per_device * n)
        sha = hashlib.sha256(json.dumps(totals, sort_keys=True).encode()).hexdigest()
        assert sha == p["report_sha256"], f"unsharded != sharded at {n} devices"
        shas[str(n)], unique[str(n)] = sha, totals["hist_unique"]
    return {"report_sha256": shas, "hist_unique": unique,
            "bytes_invariant": curve["bytes_invariant"]}


# ---------------------------------------------------------------------------
# the host tier: one program, both packages

ORIGINALS = (time.time, random.random, datetime.datetime, datetime.date, os.urandom)


def assert_stdlib_restored():
    assert (time.time, random.random, datetime.datetime, datetime.date,
            os.urandom) == ORIGINALS


def both(program, seed, config=None):
    """The reference's and the port's runs of one program (one after the
    other: the stdlib interposition is global, so they never nest), held
    equal."""
    import madsim_tpu as R
    import madsim_tpu_torch as P

    ref = run(R, program, seed, config)
    assert_stdlib_restored()
    port = run(P, program, seed, config)
    assert_stdlib_restored()
    assert port["now_ns"] == ref["now_ns"]
    assert port["draws"] == ref["draws"]
    assert port["log"] == ref["log"]
    assert port["out"] == ref["out"]
    return ref
