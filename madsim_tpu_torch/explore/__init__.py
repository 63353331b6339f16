"""Coverage-guided fault-campaign exploration: find -> triage -> shrink
(counterpart of ``madsim_tpu.explore``).

- ``campaign`` — the corpus loop: mutate ``FaultSpec``s via seeded draws,
  sweep each candidate, retain specs that light new coverage bits, and
  report every violating seed in a byte-deterministic JSONL report;
- ``triage`` — bucket violating seeds by failure fingerprint (the probe's
  flavor and first violating event from ``run_traced``, or with
  ``history=True`` the op ending the first non-linearizable prefix);
- ``shrink`` — ddmin the fired fault schedule to a minimal ``FixedFaults``
  literal that still reproduces the same fingerprint, plus campaign-window
  narrowing;
- ``targets`` — the model adapters a campaign explores;
- ``fleet`` — world-size curves and campaigns over ``parallel``'s ranks.

The reference's ``differential``, ``orchestrator``, ``steer`` and
``store`` (and ``scheduler="bandit"``) are not ported yet.
"""

from .campaign import (  # noqa: F401
    CampaignConfig,
    CampaignResult,
    mutate_spec,
    run_campaign,
    spec_from_dict,
    spec_to_dict,
    sweep_candidate_grid,
    target_envelope,
)
from .fleet import checked_sweep_curve, sharded_campaign  # noqa: F401
from .shrink import ShrinkResult, narrow_windows, shrink  # noqa: F401
from .targets import (  # noqa: F401
    Target,
    amnesia_gate,
    amnesia_raft_target,
    etcd_steer_gate,
    oracle_demo_faults,
    stale_etcd_target,
    steer_gate,
)
from .triage import (  # noqa: F401
    HISTORY_FLAVOR,
    Failure,
    fingerprint_counts,
    triage,
    triage_seed,
)
