"""Failure triage: bucket violating seeds by failure fingerprint
(counterpart of ``madsim_tpu/explore/triage.py``).

A campaign can flag thousands of red seeds; most are the same bug hit
through different schedules. Triage re-runs each seed through
``engine.run_traced`` (bit-exact on any device) and reduces it to a
**fingerprint** — the violation flavor bitmask the workload's ``probe``
latched, plus the signature of the FIRST event that latched it (event
kind + victim node). Seeds sharing a fingerprint are one failure class;
the explore report and the shrinker work per class, not per seed.

The fingerprint deliberately excludes times, steps and seeds: those vary
per schedule even when the failure mechanism is identical. What it keeps
is where the detector tripped (flavor) and what the tripping event was
(kind, node) — stable across reruns by determinism, and stable across
seeds of the same bug in practice.

A second fingerprint flavor rides on the history oracle
(madsim_tpu/oracle): with ``history=True`` a seed is re-run traced, its
recorded operation history decoded, and the failure keyed on the op
ending the **first non-linearizable prefix** — no model-specific probe
needed, just a ``Target.hist_spec``. History fingerprints keep the op
kind and drop keys/clients (those vary per schedule like times do).

Every replay runs on ``device`` (None means CUDA; the engine is
integer-only, so a card's replay equals the CPU's).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from ..engine import core as ecore
from .targets import Target

# Failure.flavor value marking a history-oracle failure (probe bitmask
# flavors are non-negative)
HISTORY_FLAVOR = -1


class Failure(NamedTuple):
    """One triaged violating seed."""

    seed: int
    flavor: int  # probe bitmask at the first violating event
    step: int  # index of that event in the dispatch order
    time_ns: int  # virtual time of that event
    kind: int  # event kind dispatched at that step
    node: int  # victim node of that event (target.node_of)
    fingerprint: str  # the dedupe key: name:flavor:kind:node


def _host(a) -> np.ndarray:
    import torch

    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _triage_history(
    target: Target, workload, ecfg, seed: int, params=None, device=None
) -> Optional[Failure]:
    """History-oracle triage: decode the seed's recorded op history and
    fingerprint the op that ends the first non-linearizable prefix.
    ``step`` is that op's index in the decoded history (not a dispatch
    step), ``kind`` its op code, ``node`` its client.

    A one-lane ``run_sweep`` replaces ``run_traced`` here: history
    triage reads only the final state's history buffer, which the two
    paths fill bit-identically (the byte contract tests/test_oracle.py
    pins), and the sweep neither materializes the max_steps-sized trace
    arrays nor runs past the seed's completion — this is the inner loop
    of ``shrink(history=True)``, one replay per ddmin candidate."""
    from ..oracle import check_history, decode_seed
    from ..oracle.history import OP_NAMES

    if target.hist_spec is None:
        raise ValueError(
            f"target {target.name!r} declares no hist_spec; history "
            "triage needs the sequential spec to check decoded ops against"
        )
    if workload.record is None or workload.hist_slots == 0:
        raise ValueError(
            f"target {target.name!r} workload records no op history "
            "(Workload.record/hist_slots); there is nothing to check"
        )
    if params is not None:
        from ..engine.faults import tile_params

        params = tile_params(params, 1)
    final = ecore.run_sweep(
        workload, ecfg, np.asarray([seed], np.int64), params=params,
        device=device,
    )
    result = check_history(decode_seed(final, 0), target.hist_spec)
    if result.ok:
        return None
    op = result.bad_op
    return Failure(
        seed=int(seed),
        flavor=HISTORY_FLAVOR,
        step=result.bad_index,
        time_ns=op.invoke_ns,
        kind=op.op,
        node=op.client,
        fingerprint=f"{target.name}:history:{OP_NAMES[op.op]}",
    )


def triage_seed(
    target: Target, faults, seed: int, history: bool = False, params=None,
    device=None,
) -> Optional[Failure]:
    """Re-run one seed traced and locate its first violating event.

    Returns None when the seed does not violate under ``faults`` (the
    workload's probe never leaves zero — or, with ``history=True``, the
    decoded op history checks linearizable) — the caller's signal that a
    candidate schedule no longer reproduces.

    ``faults`` may be a ``FaultEnvelope`` with the concrete candidate in
    ``params`` (engine/faults.py spec-as-data): the replay is
    bit-identical to the static-spec path, but every candidate of the
    envelope's width reuses ONE compiled traced program — the shrinker's
    ddmin loop replays dozens of schedules for one compile instead of
    one compile each."""
    workload, ecfg = target.build(faults)
    if history:
        return _triage_history(
            target, workload, ecfg, seed, params=params, device=device
        )
    if workload.probe is None:
        raise ValueError(
            f"target {target.name!r} workload defines no probe; triage "
            "needs the per-step violation flavor run_traced records"
        )
    _, trace = ecore.run_traced(workload, ecfg, seed, params=params, device=device)
    trace = {k: _host(v) for k, v in trace.items()}
    fired = trace["fired"]
    probe = trace["probe"]
    hits = np.nonzero(fired & (probe != 0))[0]
    if hits.size == 0:
        return None
    i = int(hits[0])
    flavor = int(probe[i])
    kind = int(trace["kind"][i])
    node = target.node_of(kind, trace["pay"][i])
    return Failure(
        seed=int(seed),
        flavor=flavor,
        step=i,
        time_ns=int(trace["time_ns"][i]),
        kind=kind,
        node=node,
        fingerprint=f"{target.name}:f{flavor}:k{kind}:n{node}",
    )


def triage(
    target: Target, faults, seeds: Sequence[int], history: bool = False,
    device=None,
) -> Dict[str, List[Failure]]:
    """Triage a batch of violating seeds into fingerprint buckets.

    Returns ``{fingerprint: [Failure, ...]}`` with each bucket's seeds in
    input order; seeds that do not violate are dropped (a campaign's
    violating-seed list can only shrink under re-verification, never
    grow). ``history=True`` routes every seed through the history
    oracle instead of the model probe."""
    buckets: Dict[str, List[Failure]] = {}
    for seed in seeds:
        f = triage_seed(target, faults, seed, history=history, device=device)
        if f is not None:
            buckets.setdefault(f.fingerprint, []).append(f)
    return buckets


def fingerprint_counts(buckets: Dict[str, List[Failure]]) -> Dict[str, int]:
    """``{fingerprint: seed count}`` — the triage headline."""
    return {fp: len(fails) for fp, fails in sorted(buckets.items())}
