"""Replay helpers of the explore loop (the port's own copy of
``madsim_tpu/replay.py``'s device-tier helpers and
``madsim_tpu/faults.py::compile_host``).

A sweep flags violating seeds (``violation_seeds``); ``core.run_traced``
replays one bit-exactly, and ``extract_fault_schedule`` lifts the fired
fault events out of its trace with the exact deadlines their payloads
carry. ``compile_host`` derives the same schedule from ``(spec, seed)``
without a replay (``engine/faults.schedule_events`` on the CPU), so the
two agree for every event inside the engine horizon.

The host-tier supervisor that applies such a schedule to async user code
(``madsim_tpu.faults.apply_schedule``) belongs to the host runtime,
which the port does not carry; a schedule from here is plain data it
accepts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

FaultEvent = Tuple[int, str, int]  # (time_ns, action name, victim node)


def _host(a) -> np.ndarray:
    import torch

    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def amnesia_raft_config():
    """The canonical cross-tier configuration: a 3-node Raft cluster
    whose crashes wipe durable state, under a fault plan aggressive
    enough that modest sweeps find double votes. ``(RaftConfig,
    EngineConfig)``, the reference's fields."""
    from .models import raft

    cfg = raft.RaftConfig(
        num_nodes=3,
        crashes=3,
        commands=0,
        volatile_state=True,
        crash_window_ns=2_000_000_000,
        restart_lo_ns=50_000_000,
        restart_hi_ns=300_000_000,
    )
    ecfg = raft.engine_config(cfg, time_limit_ns=3_000_000_000, max_steps=30_000)
    return cfg, ecfg


def violation_seeds(final) -> np.ndarray:
    """Seeds whose workload latched ``violation`` in a finished sweep."""
    return _host(final.seed)[_host(final.wstate.violation)]


def extract_fault_schedule(trace: Dict, fault_kind: int) -> List[FaultEvent]:
    """The fired fault-campaign events of a ``run_traced`` trace as
    ``(time_ns, action, victim)``, sorted by time. Times are the exact
    scheduled deadlines the payloads carry, free of dispatch jitter; a
    fault drawn past the horizon never fires and so is absent."""
    from .engine.faults import ACTION_NAMES

    k = _host(trace["kind"])
    p = _host(trace["pay"]).astype(np.int64)
    fired = _host(trace["fired"])
    plan: List[FaultEvent] = []
    for i in np.nonzero(fired & (k == fault_kind))[0]:
        t = (int(p[i, 3]) << 31) | int(p[i, 2])
        plan.append((t, ACTION_NAMES[int(p[i, 0])], int(p[i, 1])))
    return sorted(plan)


def extract_history(final, lane: Optional[int] = None):
    """The recorded operation history of a replay's final state
    (unbatched), or of lane ``lane`` of a batched sweep state."""
    from .oracle.history import decode_seed

    return decode_seed(final, lane)


def history_violation_seeds(final, spec) -> np.ndarray:
    """Seeds of a finished sweep whose decoded history fails the
    linearizability check against ``spec``."""
    from .oracle.check import violating_seeds

    return violating_seeds(final, spec)


def compile_host(spec, num_nodes: int, seed: int) -> List[FaultEvent]:
    """The campaign of one seed as a time-sorted ``(time_ns, action,
    victim)`` schedule: ``engine/faults.schedule_events`` on the CPU, the
    derivation a device sweep of that seed injects. A ``FixedFaults``
    schedule comes back verbatim, time-sorted."""
    import torch

    from .engine.faults import ACTION_NAMES, schedule_events
    from .engine.rng import seed_key

    times, actions, victims = schedule_events(
        spec, num_nodes, seed_key(torch.tensor([int(seed)], dtype=torch.int64))
    )
    return sorted(
        (int(t), ACTION_NAMES[int(a)], int(v))
        for t, a, v in zip(_host(times[0]), _host(actions[0]), _host(victims[0]))
    )
