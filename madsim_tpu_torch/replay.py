"""Cross-tier replay: device-found failure seeds → host-tier user code
(the port's own copy of ``madsim_tpu/replay.py``).

1. a sweep flags violating seeds (``violation_seeds``);
2. ``core.run_traced`` replays one bit-exactly, and
   ``extract_fault_schedule`` lifts the fired fault events out of its
   trace with the exact deadlines their payloads carry;
3. ``faults.compile_host`` derives the same schedule from ``(spec,
   seed)`` without a replay, so the two agree for every event inside the
   engine horizon;
4. ``replay_on_host`` drives host-tier user code (the port's own
   ``examples/raft_host.run_seed_with_plan``) under that schedule on the
   port's host runtime, where a debugger can step through it. Two
   engines cannot share one RNG stream, so what transfers is the fault
   environment, not the interleaving: a few host seeds are scanned.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .faults import FaultEvent, compile_host  # noqa: F401  (re-exported)


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


def replay_on_host(
    run_with_plan: Callable[[int, Sequence[FaultEvent]], Dict],
    plan: Sequence[FaultEvent],
    host_seeds: Sequence[int] = range(8),
    reproduced: Callable[[Dict], bool] = lambda r: r.get("violations", 0) > 0,
) -> Optional[Dict]:
    """Drive host-tier user code under the recorded fault plan.

    ``run_with_plan(seed, plan)`` runs one host simulation (e.g.
    ``examples.raft_host.run_seed_with_plan``); the host tier's own
    schedule randomization varies per seed, so a few seeds are scanned.
    Returns the first result where ``reproduced`` holds, else None.
    """
    for seed in host_seeds:
        result = run_with_plan(int(seed), plan)
        if reproduced(result):
            result["host_seed"] = int(seed)
            return result
    return None
