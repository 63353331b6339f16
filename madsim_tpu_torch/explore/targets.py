"""Explore targets: the model adapter a campaign/triage/shrink run drives
(counterpart of ``madsim_tpu/explore/targets.py``).

A ``Target`` is everything the explore loop needs to know about a model:
how to build a (workload, engine config) pair for a candidate fault spec,
how to summarize a finished sweep (the summary must carry
``coverage_map`` — any ``models/_common.make_sweep_summary`` product
does), and how to read an event's victim node out of a trace row for
fingerprinting. Keeping this a 5-field adapter means a new model joins
the explore pipeline with ~10 lines, no changes to the loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

from ..engine.core import EngineConfig, Workload


class Target(NamedTuple):
    """One explorable model configuration family.

    ``build(faults)`` maps a fault spec (``FaultSpec`` or ``FixedFaults``)
    to a ready ``(Workload, EngineConfig)`` pair — everything else about
    the model (nodes, workload plan, time limit) stays pinned, so
    coverage/violation differences between candidates are attributable
    to the fault environment alone."""

    name: str
    build: Callable[[object], Tuple[Workload, EngineConfig]]
    summarize: Callable[[object], dict]
    num_nodes: int
    fault_kind: int
    #: (kind, pay_row) -> victim node of the event, for fingerprints
    node_of: Callable[[int, object], int]
    #: finished batched EngineState -> violating seed array (the model
    #: decides what "violating" means; raft latches wstate.violation,
    #: history targets run the linearizability checker per lane)
    violating: Callable[[object], object]
    #: sequential spec (oracle/specs.py) for the workload's recorded op
    #: histories; set iff the workload records one (enables the
    #: ``history`` triage flavor and history-verified shrinking)
    hist_spec: Optional[object] = None


def amnesia_raft_target(
    time_limit_ns: int = 3_000_000_000,
    max_steps: int = 30_000,
    hist_slots: int = 0,
) -> Target:
    """The canonical explore target: the 3-node amnesia Raft cluster of
    ``replay.amnesia_raft_config()`` — crash wipes durable state, so the
    election-safety detector (``V_ELECTION``) can actually fire — with
    the fault campaign left OPEN for the explore loop to choose.

    ``hist_slots > 0`` turns on election-history recording and the
    oracle leg: the target gains ``hist_spec``
    (``oracle.specs.ElectionSpec``), so campaigns run the device-side
    election screen behind every chunk and the checker over the suspect
    lanes — the coverage-guided + history-checked configuration the
    sharded million-seed campaign sweeps (``explore.fleet``).
    "Violating" stays the model's latched flag either way: for raft the
    election screen is PRECISE (== ``ElectionSpec.structural``), so the
    two signals agree seed for seed (asserted in tests/test_oracle.py)."""
    from ..models import raft
    from ..replay import amnesia_raft_config, violation_seeds

    base_cfg, _ = amnesia_raft_config()
    if hist_slots:
        base_cfg = base_cfg._replace(hist_slots=hist_slots)

    def build(faults) -> Tuple[Workload, EngineConfig]:
        cfg = base_cfg._replace(faults=faults)
        ecfg = raft.engine_config(
            cfg, time_limit_ns=time_limit_ns, max_steps=max_steps
        )
        return raft.workload(cfg), ecfg

    def node_of(kind: int, pay) -> int:
        return int(pay[1]) if kind == raft.K_FAULT else int(pay[0])

    return Target(
        name="raft-amnesia",
        build=build,
        summarize=raft.sweep_summary,
        num_nodes=base_cfg.num_nodes,
        fault_kind=raft.K_FAULT,
        node_of=node_of,
        violating=violation_seeds,
        hist_spec=raft.history_spec() if hist_slots else None,
    )


# the (target, base FaultSpec) pair the multichip gates sweep — ONE
# definition shared by the entry module's dry-run curve and the card's
# campaign phase, so retuning the gate spec (e.g. a crash-window change
# that keeps violations > 0) retunes every gate
def amnesia_gate(smoke: bool = True):
    from ..engine.faults import FaultSpec

    target = amnesia_raft_target(
        time_limit_ns=1_500_000_000 if smoke else 3_000_000_000,
        max_steps=15_000 if smoke else 30_000,
        hist_slots=16,
    )
    base = FaultSpec(
        crashes=3,
        crash_window_ns=1_200_000_000 if smoke else 2_000_000_000,
        restart_lo_ns=50_000_000,
        restart_hi_ns=300_000_000,
    )
    return target, base


# the (target, base FaultSpec) pairs the steering A/B drills sweep.
# The raft pair reuses the amnesia gate spec on purpose:
# its base family is pure crashes, so the default family universe
# (explore.steer.family_universe) is mostly amnesia-blind duds — the
# exact shape where a uniform grid burns budget and the bandit's
# early-kill pays. The etcd pair reuses the oracle demo's partition
# spec the same way.
def steer_gate(smoke: bool = True):
    return amnesia_gate(smoke)


def etcd_steer_gate(smoke: bool = True):
    target = stale_etcd_target(
        time_limit_ns=1_000_000_000 if smoke else 2_000_000_000,
        max_steps=10_000 if smoke else 20_000,
    )
    return target, oracle_demo_faults()


# the fault environment the history-oracle pipeline runs under — the
# reference's definition, so a seed either package reports reproduces
# under the other (same (spec, seed) -> same schedule -> same decoded
# history)
def oracle_demo_faults():
    from ..engine.faults import FaultSpec

    return FaultSpec(
        partitions=2, part_window_ns=1_500_000_000, part_group=(1, -1)
    )


def stale_etcd_target(
    time_limit_ns: int = 2_000_000_000,
    max_steps: int = 20_000,
    hist_slots: int = 256,
    bug_stale_read: bool = True,
) -> Target:
    """The history-oracle demo target: the etcd cluster with
    ``bug_stale_read`` seeded — GETs serve the pre-mutation value, which
    no online invariant latch can see (revision and lease bookkeeping
    stay intact) — and history recording on, so "violating" means *the
    WGL checker rejects the seed's decoded history* against the KV
    register spec. Pass ``bug_stale_read=False`` for the matching clean
    control (the checker must stay quiet over any pinned seed range)."""
    from ..models import etcd
    from ..oracle.check import violating_seeds as history_violating

    base_cfg = etcd.EtcdConfig(
        bug_stale_read=bug_stale_read, hist_slots=hist_slots
    )
    spec = etcd.history_spec()

    def build(faults) -> Tuple[Workload, EngineConfig]:
        cfg = base_cfg._replace(faults=faults)
        ecfg = etcd.engine_config(
            cfg, time_limit_ns=time_limit_ns, max_steps=max_steps
        )
        return etcd.workload(cfg), ecfg

    def node_of(kind: int, pay) -> int:
        return int(pay[1]) if kind == etcd.K_FAULT else int(pay[0])

    return Target(
        name="etcd-stale" if bug_stale_read else "etcd-clean",
        build=build,
        summarize=etcd.sweep_summary,
        num_nodes=base_cfg.num_nodes,
        fault_kind=etcd.K_FAULT,
        node_of=node_of,
        # screened: the device first pass (oracle/screen.py) clears the
        # boring lanes and WGL runs on the suspects only — identical
        # seeds by the conservatism contract, so campaign loops can use
        # the oracle as their red-seed signal at sweep speed
        violating=lambda final: history_violating(final, spec, screen=True),
        hist_spec=spec,
    )
