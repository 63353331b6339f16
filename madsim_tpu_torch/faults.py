"""Host-tier fault campaigns: the second backend of the FaultSpec compiler.

``engine/faults.py`` owns the declarative ``FaultSpec`` and THE schedule
derivation (``schedule_events``); this module compiles the same spec for
the host tier:

- ``compile_host(spec, num_nodes, seed)`` evaluates the identical
  derivation for one seed and returns the time-sorted ``(time_ns, action,
  victim)`` schedule — byte-for-byte the schedule a device sweep of that
  seed injects (asserted by ``tests/test_faults.py``).
- ``apply_schedule`` is the async supervisor task: it sleeps to each
  event's virtual time and applies it through the live simulation's
  public APIs — ``Handle.kill/restart/pause/resume`` for crash/restart/
  pause events (ref runtime/mod.rs:272-303), the ``NetSim`` fault
  surface (directional ``clog_node_in/out``, latency/loss config) for
  partition and burst events (ref net/mod.rs:163-284), the ``FsSim``
  durability surface (``stall_fsync``/``unstall_fsync``/``power_fail``)
  for the slow-disk and power-fail gray failures, and the per-node
  clock-skew registry on ``TimeHandle`` for skew windows.
- ``run_campaign`` composes the two: one call drives a whole campaign
  against a list of nodes.

Semantics mirror the device interpreter exactly: crash/restart and
pause/resume are edge-gated (restarting a live node is a no-op, as in
``models/raft._on_fault``), partitions are refcounted per victim, and
latency/loss bursts are refcounted with base values restored from the
config present when the supervisor started.

This is the replay bridge's other half: a violation seed found by a TPU
sweep replays its *fault environment* on the host either from the spec
directly (``compile_host``) or from a traced schedule
(``replay.extract_fault_schedule``) — the two agree by construction.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

if TYPE_CHECKING:  # the engine (and thus torch) is only a runtime
    from .engine.faults import FaultSpec  # dependency of compile_host —
    # this module stays importable on the torch-free host tier (forked-procs
    # children poison torch deliberately; builder._poison_device_tier_in_child)

#: one schedule entry: (virtual time ns, action name, victim node index)
FaultEvent = Tuple[int, str, int]


def compile_host(spec: FaultSpec, num_nodes: int, seed: int) -> List[FaultEvent]:
    """Compile the campaign for one seed into a time-sorted schedule.

    Runs the shared derivation (tiny — a few dozen integer draws) with
    torch on the CPU; the result is integer-only and therefore identical
    to what the device tier injects for the same ``(spec, seed)``. A
    literal ``engine.faults.FixedFaults`` schedule (e.g. a shrunk one
    from ``explore/shrink.py``) compiles seed-independently — its events
    come back verbatim, time-sorted."""
    import torch

    from .engine.faults import ACTION_NAMES, schedule_events
    from .engine.rng import seed_key

    times, actions, victims = schedule_events(
        spec, num_nodes, seed_key(torch.tensor([int(seed)], dtype=torch.int64))
    )
    return sorted(
        (int(t), ACTION_NAMES[int(a)], int(v))
        for t, a, v in zip(times[0].tolist(), actions[0].tolist(), victims[0].tolist())
    )


async def apply_schedule(
    schedule: Sequence[FaultEvent],
    nodes: Sequence,
    spec: Optional[FaultSpec] = None,
    handle=None,
    net=None,
) -> None:
    """Apply a compiled schedule to live ``nodes`` at its virtual times.

    ``nodes[victim]`` maps schedule victims to node handles (any
    ``NodeRef``). ``spec`` is only required when the schedule contains
    latency-spike, loss-burst or clock-skew events (it carries the
    override values; ``FixedFaults`` carries them too). Must run inside
    a simulation (a supervisor task, like the manual kill/clog loops it
    replaces)."""
    from .context import current_handle
    from .fs import FsSim
    from .net import NetSim
    from .runtime import _node_id
    from .time import elapsed, sleep

    h = handle if handle is not None else current_handle()
    ns = net if net is not None else h.simulator(NetSim)

    dead = [False] * len(nodes)
    paused = [False] * len(nodes)
    # per-direction partition refcounts (mirrors FaultState.part_in_cnt /
    # part_out_cnt): a symmetric partition holds both directions, an
    # asymmetric window one — a heal never un-clogs a direction an
    # overlapping asymmetric window still holds, and vice versa
    part_in_cnt = [0] * len(nodes)
    part_out_cnt = [0] * len(nodes)
    fsync_cnt = [0] * len(nodes)
    skew_cnt = [0] * len(nodes)
    spike_cnt = 0
    loss_cnt = 0
    base_latency = ns.config.net.send_latency
    base_loss = ns.config.net.packet_loss_rate

    def _clog_dir(victim: int, cnt, clog, unclog, delta: int) -> None:
        """Refcounted one-direction clog: apply on 0->1, restore on 1->0."""
        nid = _node_id(nodes[victim])
        if delta > 0:
            if cnt[victim] == 0:
                clog(nid)
            cnt[victim] += 1
        else:
            if cnt[victim] == 1:
                unclog(nid)
            cnt[victim] = max(cnt[victim] - 1, 0)

    def _set_net(latency=None, loss=None):
        # NetSim and its Network normally share one Config object; write
        # through both in case a caller swapped one via update_config
        for cfg in (ns.config, ns.network.config):
            if latency is not None:
                cfg.net.send_latency = latency
            if loss is not None:
                cfg.net.packet_loss_rate = loss

    def _needs_spec() -> FaultSpec:
        if spec is None:
            raise ValueError(
                "schedule contains latency/loss burst events; pass the "
                "FaultSpec so the supervisor knows the override values"
            )
        return spec

    for t_ns, action, victim in schedule:
        dt = t_ns / 1e9 - elapsed()
        if dt > 0:
            await sleep(dt)
        if action in ("crash", "power_fail"):
            # both flavors drop unsynced storage: Handle.kill resets every
            # simulator (FsSim.reset_node == power_fail); the power_fail
            # action drives the fs machinery explicitly as well, so the
            # storage edge fires even under a custom fs configuration
            if not dead[victim]:
                if action == "power_fail":
                    h.simulator(FsSim).power_fail(_node_id(nodes[victim]))
                h.kill(nodes[victim])
                dead[victim] = True
                paused[victim] = False
        elif action == "restart":
            if dead[victim]:
                h.restart(nodes[victim])
                dead[victim] = False
        elif action == "partition":
            _clog_dir(victim, part_in_cnt, ns.clog_node_in, ns.unclog_node_in, +1)
            _clog_dir(victim, part_out_cnt, ns.clog_node_out, ns.unclog_node_out, +1)
        elif action == "heal":
            _clog_dir(victim, part_in_cnt, ns.clog_node_in, ns.unclog_node_in, -1)
            _clog_dir(victim, part_out_cnt, ns.clog_node_out, ns.unclog_node_out, -1)
        elif action == "part_in":
            _clog_dir(victim, part_in_cnt, ns.clog_node_in, ns.unclog_node_in, +1)
        elif action == "heal_in":
            _clog_dir(victim, part_in_cnt, ns.clog_node_in, ns.unclog_node_in, -1)
        elif action == "part_out":
            _clog_dir(victim, part_out_cnt, ns.clog_node_out, ns.unclog_node_out, +1)
        elif action == "heal_out":
            _clog_dir(victim, part_out_cnt, ns.clog_node_out, ns.unclog_node_out, -1)
        elif action == "fsync_stall":
            if fsync_cnt[victim] == 0:
                h.simulator(FsSim).stall_fsync(_node_id(nodes[victim]))
            fsync_cnt[victim] += 1
        elif action == "fsync_ok":
            if fsync_cnt[victim] == 1:
                h.simulator(FsSim).unstall_fsync(_node_id(nodes[victim]))
            fsync_cnt[victim] = max(fsync_cnt[victim] - 1, 0)
        elif action == "skew_on":
            s = _needs_spec()
            if skew_cnt[victim] == 0:
                h.time.set_node_skew(
                    _node_id(nodes[victim]), s.skew_num, s.skew_den
                )
            skew_cnt[victim] += 1
        elif action == "skew_off":
            if skew_cnt[victim] == 1:
                h.time.clear_node_skew(_node_id(nodes[victim]))
            skew_cnt[victim] = max(skew_cnt[victim] - 1, 0)
        elif action == "spike_on":
            spike_cnt += 1
            if spike_cnt == 1:
                s = _needs_spec()
                _set_net(
                    latency=(s.spike_lat_lo_ns / 1e9, s.spike_lat_hi_ns / 1e9)
                )
        elif action == "spike_off":
            if spike_cnt == 1:
                _set_net(latency=base_latency)
            spike_cnt = max(spike_cnt - 1, 0)
        elif action == "loss_on":
            loss_cnt += 1
            if loss_cnt == 1:
                s = _needs_spec()
                _set_net(loss=s.burst_loss_q32 / 2**32)
        elif action == "loss_off":
            if loss_cnt == 1:
                _set_net(loss=base_loss)
            loss_cnt = max(loss_cnt - 1, 0)
        elif action == "pause":
            if not dead[victim] and not paused[victim]:
                h.pause(nodes[victim])
                paused[victim] = True
        elif action == "resume":
            if not dead[victim] and paused[victim]:
                h.resume(nodes[victim])
                paused[victim] = False
        else:
            raise ValueError(f"unknown fault action {action!r}")


async def run_campaign(
    spec: FaultSpec,
    nodes: Sequence,
    seed: Optional[int] = None,
    handle=None,
    net=None,
) -> List[FaultEvent]:
    """Compile the campaign for ``seed`` (default: the running sim's own
    seed) and apply it to ``nodes``; returns the applied schedule."""
    from .context import current_handle

    h = handle if handle is not None else current_handle()
    schedule = compile_host(spec, len(nodes), h.seed if seed is None else seed)
    await apply_schedule(schedule, nodes, spec=spec, handle=h, net=net)
    return schedule
