"""Host↔device differential validation (counterpart of
``madsim_tpu/explore/differential.py``).

The reference holds two independent implementations of one workload —
the device Raft model (``models/raft.py``, amnesia mode) and the host
executor's Raft example (``examples/raft_host.py``, ordinary async code
whose in-memory state IS amnesia) — and one declarative fault campaign
drives both. Over a matched ``(spec, seed)`` grid it requires

1. **matched outcome distributions**: the per-seed election/no-leader/
   violation rates of the two tiers agree within documented tolerances
   (two engines cannot share an RNG stream, so individual seeds differ;
   the distributions must not);
2. **one sequential spec for both histories**: each tier's election
   history is checked against ``oracle.specs.ElectionSpec`` — per seed,
   per tier, the checker's verdict must agree exactly with that tier's
   own online violation latch;
3. **byte-deterministic reports**: the JSON report carries only integer
   counts and sorted keys.

The device half is ``device_outcomes``, ``device_outcomes_grid`` (one
spec-as-data sweep for the whole spec set) and ``_fold_device``; every
device sweep runs on ``device`` (None means CUDA). The host half,
``host_outcomes``, runs the port's own host-tier raft example
(``madsim_tpu_torch/examples/raft_host.py``) on the port's host runtime,
which is the CPU tier by design; ``run_differential(host=)`` takes the
host outcomes from the caller instead. ``data/differential_host.json``
(made by the JAX package, keyed by ``host_key``) is a golden only.

Tolerances are in per-mille of the seed count: election presence and
no-leader rates track within a few percent; violation rates differ more
(the host example polls its election deadline at 10 ms granularity and
has no log, so its double-vote window differs) and get a wider band.
"""

from __future__ import annotations

import json
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from ..engine import core as ecore
from ..engine.faults import FaultSpec
from ..oracle import ElectionSpec, check_history, decode_sweep
from ..oracle.history import host as _host
from .campaign import spec_to_dict

class DifferentialConfig(NamedTuple):
    """Grid parameters (hashable, reprs stably)."""

    num_nodes: int = 3
    seeds: int = 200
    seed0: int = 0
    sim_seconds: float = 2.0
    chunk_size: int = 16384
    # device raft sizing: the election-safety ring and the history
    # buffer must cover every election of a seed, else the online latch
    # and the checker see different data (overflows are surfaced in the
    # report and fail the gate)
    history_ring: int = 64
    hist_slots: int = 128
    # per-mille tolerances on |device - host| outcome rates
    tol_elected_pm: int = 100
    tol_no_leader_pm: int = 100
    tol_violation_pm: int = 300


class TierOutcome(NamedTuple):
    """One tier's per-seed outcomes over the grid (integer counts)."""

    elected_seeds: int  # seeds with >= 1 election
    no_leader_seeds: int
    violation_seeds: int  # that tier's own online latch
    elections_total: int
    commits_total: int  # device only (the host example is election-only)
    hist_reject_seeds: int  # seeds whose history fails ElectionSpec
    hist_mismatch_seeds: int  # checker verdict != online latch
    hist_overflow_seeds: int
    # device only: lanes whose event queue overflowed — a truncated lane
    # under-counts outcomes, so any overflow fails the gate
    overflow_seeds: int = 0


def _pm(count: int, total: int) -> int:
    """Integer per-mille — float-free so reports are byte-stable."""
    return 1000 * count // total


def _device_raft_cfg(faults, dcfg: DifferentialConfig):
    """The device raft model of the differential grid (amnesia mode —
    matching the host example's in-memory state), with the fault slot
    open for a concrete spec OR the grid's shared ``FaultEnvelope``."""
    from ..models import raft

    cfg = raft.RaftConfig(
        num_nodes=dcfg.num_nodes,
        commands=0,
        volatile_state=True,
        history=dcfg.history_ring,
        hist_slots=dcfg.hist_slots,
        faults=faults,
    )
    ecfg = raft.engine_config(
        cfg,
        time_limit_ns=int(dcfg.sim_seconds * 1e9),
        max_steps=60_000,
    )
    return raft.workload(cfg), ecfg


def device_outcomes(
    spec, dcfg: DifferentialConfig = DifferentialConfig(), device=None
) -> TierOutcome:
    """Sweep the device raft model over the grid on ``device`` (None
    means CUDA) and fold per-seed outcomes, checking every decoded
    election history against ElectionSpec. One sweep PER SPEC — the
    reference the grid equality test pins (``TierOutcome``s equal to
    ``device_outcomes_grid``'s)."""
    workload, ecfg = _device_raft_cfg(spec, dcfg)
    seeds = np.arange(dcfg.seed0, dcfg.seed0 + dcfg.seeds, dtype=np.int64)
    final = ecore.run_sweep_chunked(
        workload, ecfg, seeds, chunk_size=dcfg.chunk_size, device=device
    )
    return _fold_device(final, dcfg)


def device_outcomes_grid(
    specs: Sequence, dcfg: DifferentialConfig = DifferentialConfig(), device=None
) -> List[TierOutcome]:
    """All specs' device outcomes from ONE sweep on ``device`` (None
    means CUDA): the spec-as-data grid (engine/faults.py). The K specs
    share one ``FaultEnvelope`` (``campaign_envelope``), each rides in as
    per-lane ``FaultParams`` over its copy of the seed range
    (``grid_params``), and the whole K x seeds grid runs as one batch;
    each spec's lanes are carved out with ``lane_slice``. Per-seed states
    (and so the folded ``TierOutcome`` integers and report bytes) are
    bit-identical to ``device_outcomes`` per spec."""
    from ..engine.core import lane_slice
    from ..engine.faults import campaign_envelope, grid_params, spec_to_params

    env = campaign_envelope(*specs)
    workload, ecfg = _device_raft_cfg(env, dcfg)
    n = dcfg.seeds
    seeds = np.tile(
        np.arange(dcfg.seed0, dcfg.seed0 + n, dtype=np.int64), len(specs)
    )
    params = grid_params(
        [spec_to_params(spec, env, dcfg.num_nodes) for spec in specs], n
    )
    final = ecore.run_sweep_chunked(
        workload, ecfg, seeds,
        chunk_size=max(dcfg.chunk_size, n), params=params, device=device,
    )
    return [
        _fold_device(lane_slice(final, n, k * n), dcfg)
        for k in range(len(specs))
    ]


def _fold_device(final, dcfg: DifferentialConfig) -> TierOutcome:
    """Fold one spec's finished lane block into its ``TierOutcome``
    (host numpy, summed as the reference sums: int32 counts to int64,
    every field a plain ``int``)."""
    elections = _host(final.wstate.elections)
    commits = _host(final.wstate.commits)
    violation = _host(final.wstate.violation)
    # clipped-coverage lanes: the oracle buffer latched hist_overflow OR
    # the online latch's election ring wrapped (it has no latch of its
    # own — more elections than ring slots means the latch may have
    # missed a duplicate term, which would otherwise surface only as a
    # confusing latch/checker mismatch)
    overflow = _host(final.hist_overflow) | (
        elections > dcfg.history_ring
    )
    espec = ElectionSpec()
    rejects = 0
    mismatches = 0
    for lane, hist in enumerate(decode_sweep(final)):
        bad = not check_history(hist, espec).ok
        rejects += bad
        mismatches += bad != bool(violation[lane])
    return TierOutcome(
        elected_seeds=int((elections > 0).sum()),
        no_leader_seeds=int((elections == 0).sum()),
        violation_seeds=int(violation.sum()),
        elections_total=int(elections.sum(dtype=np.int64)),
        commits_total=int(commits.sum(dtype=np.int64)),
        hist_reject_seeds=int(rejects),
        hist_mismatch_seeds=int(mismatches),
        hist_overflow_seeds=int(overflow.sum()),
        overflow_seeds=int(_host(final.overflow).sum()),
    )



def host_key(spec, dcfg: DifferentialConfig) -> str:
    """The key of one grid's host outcomes in the golden
    ``data/differential_host.json``: the spec's canonical dict and the
    config (floats kept out, as in the report), as sorted JSON."""
    return json.dumps({"spec": spec_to_dict(spec), "config": _config(dcfg)}, sort_keys=True)


def host_outcomes(
    spec, dcfg: DifferentialConfig = DifferentialConfig()
) -> TierOutcome:
    """Run the host-tier raft example once per grid seed under the SAME
    compiled fault schedule (``campaign_seed = seed``, so the fault
    environment matches the device lane of that seed by construction)
    and fold the same outcomes, checking each recorded history.

    ``extend=False``: a matched grid needs matched horizons — the host
    run hard-stops at ``sim_seconds`` exactly like the device lane stops
    at ``time_limit_ns``, instead of extending past a schedule that
    outlives the window (the replay pipeline's default)."""
    from ..examples import raft_host

    espec = ElectionSpec()
    elected = no_leader = violating = total = 0
    rejects = mismatches = 0
    for seed in range(dcfg.seed0, dcfg.seed0 + dcfg.seeds):
        out = raft_host.run_seed_with_spec(
            seed, spec, seed, n=dcfg.num_nodes, sim_seconds=dcfg.sim_seconds,
            extend=False,
        )
        n_elec = out["leaders_elected"]
        total += n_elec
        elected += n_elec > 0
        no_leader += n_elec == 0
        vio = out["violations"] > 0
        violating += vio
        bad = not check_history(out["history"], espec).ok
        rejects += bad
        mismatches += bad != vio
    return TierOutcome(
        elected_seeds=int(elected),
        no_leader_seeds=int(no_leader),
        violation_seeds=int(violating),
        elections_total=int(total),
        commits_total=0,
        hist_reject_seeds=int(rejects),
        hist_mismatch_seeds=int(mismatches),
        hist_overflow_seeds=0,
    )


def compare(
    dev: TierOutcome, host: TierOutcome, dcfg: DifferentialConfig
) -> dict:
    """Tolerance verdict for one spec: rate deltas in per-mille, plus
    the exact history-agreement requirements."""
    n = dcfg.seeds
    deltas = {
        "elected_pm": abs(_pm(dev.elected_seeds, n) - _pm(host.elected_seeds, n)),
        "no_leader_pm": abs(
            _pm(dev.no_leader_seeds, n) - _pm(host.no_leader_seeds, n)
        ),
        "violation_pm": abs(
            _pm(dev.violation_seeds, n) - _pm(host.violation_seeds, n)
        ),
    }
    ok = (
        deltas["elected_pm"] <= dcfg.tol_elected_pm
        and deltas["no_leader_pm"] <= dcfg.tol_no_leader_pm
        and deltas["violation_pm"] <= dcfg.tol_violation_pm
        # the sequential spec must agree with each tier's own latch,
        # seed by seed — and no device lane may have been truncated
        # (clipped history buffer or overflowed event queue)
        and dev.hist_mismatch_seeds == 0
        and host.hist_mismatch_seeds == 0
        and dev.hist_overflow_seeds == 0
        and dev.overflow_seeds == 0
    )
    return {"deltas": deltas, "pass": ok}


def _config(dcfg: DifferentialConfig) -> dict:
    # floats are kept out of the canonical encoding
    return {
        **dcfg._asdict(),
        "sim_seconds": None,
        "sim_ns": int(dcfg.sim_seconds * 1e9),
    }


def run_differential(
    specs: Sequence,
    dcfg: DifferentialConfig = DifferentialConfig(),
    report_path: Optional[str] = None,
    host: Optional[Sequence[TierOutcome]] = None,
    device=None,
) -> dict:
    """Run the matched grid for every spec; returns (and optionally
    writes, as canonical JSON) the full report. ``report["pass"]`` is
    the gate verdict: every spec's tolerance check held.

    The device half runs as ONE spec-as-data grid on ``device`` (None
    means CUDA; ``device_outcomes_grid``, equal per spec to
    ``device_outcomes``). The host half is ``host`` (one
    ``TierOutcome`` per spec) when given, else ``host_outcomes``."""
    hosts = list(host) if host is not None else [host_outcomes(s, dcfg) for s in specs]
    if len(hosts) != len(specs):
        raise ValueError(f"{len(hosts)} host outcomes for {len(specs)} specs")
    devs = device_outcomes_grid(specs, dcfg, device=device)
    records: List[dict] = []
    for spec, dev, host_out in zip(specs, devs, hosts):
        verdict = compare(dev, host_out, dcfg)
        records.append(
            {
                "spec": spec_to_dict(spec),
                "device": dev._asdict(),
                "host": host_out._asdict(),
                **verdict,
            }
        )
    report = {
        "config": _config(dcfg),
        "grid": [dcfg.seed0, dcfg.seed0 + dcfg.seeds],
        "specs": records,
        "pass": all(r["pass"] for r in records),
    }
    if report_path is not None:
        with open(report_path, "w") as f:
            f.write(json.dumps(report, sort_keys=True) + "\n")
    return report


def gate_specs() -> List[FaultSpec]:
    """The differential gate's spec set: a clean-ish crash-storm
    baseline plus one spec per gray-failure family (asymmetric
    partitions, fsync-stall + power-fail, clock skew) — every window
    well inside the default 2 s horizon so the full fault environment
    transfers to both tiers."""
    return [
        # crash storm (the amnesia baseline both tiers find violations in)
        FaultSpec(
            crashes=3,
            crash_window_ns=1_200_000_000,
            restart_lo_ns=50_000_000,
            restart_hi_ns=300_000_000,
        ),
        # asymmetric partitions: one-directional link loss
        FaultSpec(
            crashes=1,
            crash_window_ns=1_000_000_000,
            restart_lo_ns=50_000_000,
            restart_hi_ns=300_000_000,
            aparts=2,
            apart_window_ns=1_200_000_000,
            apart_lo_ns=200_000_000,
            apart_hi_ns=600_000_000,
        ),
        # slow disks + power loss: crash-without-sync
        FaultSpec(
            fsync_stalls=2,
            fsync_window_ns=1_200_000_000,
            fsync_lo_ns=300_000_000,
            fsync_hi_ns=800_000_000,
            power_fails=2,
            power_window_ns=1_200_000_000,
            power_lo_ns=50_000_000,
            power_hi_ns=300_000_000,
        ),
        # clock skew: a drifting node's timers stretch 1.5x
        FaultSpec(
            crashes=1,
            crash_window_ns=1_000_000_000,
            restart_lo_ns=50_000_000,
            restart_hi_ns=300_000_000,
            skews=2,
            skew_window_ns=1_200_000_000,
            skew_lo_ns=300_000_000,
            skew_hi_ns=900_000_000,
        ),
    ]
