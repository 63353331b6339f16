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
- ``fleet`` — world-size curves and campaigns over ``parallel``'s ranks;
- ``store`` / ``orchestrator`` — the crash-safe fleet tier: a shared
  byte-deterministic corpus/bug store (sha-guarded append-only logs,
  quarantine, expiring leases, the reference's on-disk format) and the
  leased-unit worker loop feeding ``stream_sweep`` in flight, with the
  regression-replay gate;
- ``steer`` — the self-steering scheduler: candidate families, a
  deterministic UCB bandit over novel-coverage-bits-per-event,
  early-kill and budget escalation, every decision in a byte-reproducible
  trace (``CampaignConfig.scheduler="bandit"``);
- ``differential`` — host↔device differential validation: the device
  raft model's outcomes over a matched ``(spec, seed)`` grid against the
  host tier's (made by the JAX package and read as data), both checked
  against one sequential spec.
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
from .orchestrator import (  # noqa: F401
    merged_report,
    plan_unit,
    regression_gate,
    run_worker,
    write_merged,
)
from .steer import (  # noqa: F401
    BanditScheduler,
    SteerConfig,
    SteerResult,
    family_candidate,
    family_key,
    family_of,
    family_universe,
    fold_family_stats,
    plan_unit_steered,
    run_steered,
)
from .store import CorpusStore, Lease, ReadStats  # noqa: F401
from .differential import (  # noqa: F401
    DifferentialConfig,
    TierOutcome,
    device_outcomes,
    device_outcomes_grid,
    gate_specs,
    host_outcomes,
    run_differential,
)
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
