"""Rank jobs of the port's mesh, explore and entry parity tests
(``tests/test_torch_mesh.py``, ``test_torch_explore.py``,
``test_torch_entry.py``).

A job runs on every rank of a ``madsim_tpu_torch.parallel.World`` as
``job(mesh, *args)``: the ranks are spawned processes that import this
module, so it imports the port only (no JAX), and every job returns host
values (numpy arrays, dicts). The configs here are the port's halves of
the tests' cases; the tests build the reference's halves from the same
fields."""

import json
import os

import numpy as np

# the tier-1 cut of the reference tests' horizons (tests/test_parallel.py
# runs 1 s at 8,000 steps): an eager CPU step costs about the same at 16
# lanes as at 1,024, so a run costs its step count
KW = dict(time_limit_ns=300_000_000, max_steps=4_000)
# the reference test's raft fields (tests/test_parallel.py CFG; its
# loss_q32 is prob_to_q32(0.01), added where a config is built)
RAFT = dict(num_nodes=3, crashes=1)
LOSS = 0.01
ETCD_HIST = dict(hist_slots=64)
STALE = dict(hist_slots=64, bug_stale_read=True)
# the reference campaign test's target (test_parallel.py:237-264)
AMNESIA = dict(time_limit_ns=1_000_000_000, max_steps=10_000, hist_slots=16)
AMNESIA_BASE = dict(crashes=2, crash_window_ns=800_000_000,
                    restart_lo_ns=50_000_000, restart_hi_ns=300_000_000)
# a violating (spec, seed) of that target: 3 crashes, seed 44
VIOLATING = dict(AMNESIA_BASE, crashes=3)
VIOLATING_SEED = 44


def port_case(model: str):
    """(workload, engine config, summary) of one of the port's cases."""
    from madsim_tpu_torch.engine.rng import prob_to_q32
    from madsim_tpu_torch.models import etcd, kafka, raft

    if model == "raft":
        cfg = raft.RaftConfig(**RAFT, loss_q32=prob_to_q32(LOSS))
        return raft.workload(cfg), raft.engine_config(cfg, queue_capacity=32, **KW), \
            raft.sweep_summary
    mod, fields = {
        "etcd": (etcd, {}), "kafka": (kafka, {}),
        "etcd_hist": (etcd, ETCD_HIST), "etcd_stale": (etcd, STALE),
    }[model]
    cfg = (etcd.EtcdConfig if mod is etcd else kafka.KafkaConfig)(**fields)
    return mod.workload(cfg), mod.engine_config(cfg, **KW), mod.sweep_summary


def host_leaves(state) -> list:
    from madsim_tpu_torch.engine import tree

    return [a.detach().cpu().numpy() for a in tree.leaves(state)]


def sweep_leaves(mesh, model: str, n: int) -> list:
    """``run_sweep_sharded`` of seeds ``0..n-1``."""
    from madsim_tpu_torch import parallel

    wl, ecfg, _ = port_case(model)
    return host_leaves(parallel.run_sweep_sharded(wl, ecfg, np.arange(n), mesh))


def counted_sweep_leaves(mesh, model: str, n: int):
    """``sweep_leaves`` with this rank's batched engine steps and pop-min
    launches counted (``core.StepCount``): ``(leaves, calls, launches)``."""
    from madsim_tpu_torch.engine import core

    with core.StepCount() as count:
        leaves = sweep_leaves(mesh, model, n)
    return leaves, count.batched, count.launches


def chunked_leaves(mesh, model: str, seeds, cpd: int) -> list:
    """``run_sweep_sharded_chunked`` of ``seeds`` at ``cpd`` lanes per rank."""
    from madsim_tpu_torch import parallel

    wl, ecfg, _ = port_case(model)
    return host_leaves(parallel.run_sweep_sharded_chunked(
        wl, ecfg, np.asarray(seeds), mesh, chunk_per_device=cpd))


def refusals(mesh) -> list:
    """The errors of a sweep and a resume whose batch does not divide the
    world size (the ranks raise before any collective)."""
    from madsim_tpu_torch import parallel
    from madsim_tpu_torch.engine import core

    wl, ecfg, _ = port_case("raft")
    out = []
    for fn in (
        lambda: parallel.run_sweep_sharded(wl, ecfg, np.arange(mesh.size + 1), mesh),
        lambda: parallel.resume_sweep_sharded(
            wl, ecfg, core.init_sweep(wl, ecfg, np.arange(mesh.size + 1), device="cpu"), mesh),
    ):
        try:
            fn()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def stepped(mesh, n: int, steps: int):
    """``sharded_step(steps)`` from a fresh raft batch: the gathered leaves
    and the live count."""
    from madsim_tpu_torch import parallel
    from madsim_tpu_torch.engine import core

    wl, ecfg, _ = port_case("raft")
    local = core.init_sweep(wl, ecfg, parallel.shard_seeds(mesh, np.arange(n)),
                            device=mesh.device)
    local, live = parallel.sharded_step(wl, ecfg, mesh)(local, steps)
    return host_leaves(parallel.gather_state(mesh, local)), live


def screened(mesh, n: int, block: int):
    """The etcd history sweep's suspect mask, screened on the mesh."""
    from madsim_tpu_torch import parallel
    from madsim_tpu_torch.models import etcd
    from madsim_tpu_torch.oracle.screen import screen_sweep

    wl, ecfg, _ = port_case("etcd_stale")
    final = parallel.run_sweep_sharded(wl, ecfg, np.arange(n), mesh)
    return screen_sweep(final, etcd.history_spec(), block=block, mesh=mesh).cpu().numpy()


def checked(mesh, n: int, cpd: int, driver: str = "chunked") -> str:
    """``checked_sweep(mesh=)`` of the stale-read etcd sweep, as JSON."""
    from madsim_tpu_torch.models import etcd
    from madsim_tpu_torch.oracle.screen import checked_sweep

    wl, ecfg, summarize = port_case("etcd_stale")
    return json.dumps(checked_sweep(
        wl, ecfg, np.arange(n), etcd.history_spec(), summarize, mesh=mesh,
        chunk_per_device=cpd, driver=driver), sort_keys=True)


def streamed(mesh, n: int, chunk: int, pool: int, path: str) -> tuple:
    """``stream_sweep(mesh=)`` of the stale-read etcd sweep as JSON:
    straight, and stopped after 2 rounds (a v9 snapshot at ``path``, rank
    0 writing it) then resumed."""
    from madsim_tpu_torch.engine.stream import stream_sweep

    wl, ecfg, summarize = port_case("etcd_stale")
    kw = dict(chunk_size=chunk, pool_size=pool, round_steps=64, mesh=mesh)
    straight = stream_sweep(wl, ecfg, np.arange(n), summarize, **kw)
    stream_sweep(wl, ecfg, np.arange(n), summarize, ckpt_path=path, stop_after_rounds=2, **kw)
    resumed = stream_sweep(wl, ecfg, np.arange(n), summarize, resume_from=path, **kw)
    return json.dumps(straight, sort_keys=True), json.dumps(resumed, sort_keys=True)


def _short():
    wl, ecfg, _ = port_case("etcd_hist")
    return wl, ecfg._replace(max_steps=60)


def interrupted(mesh, n: int, cpd: int, path: str) -> list:
    """Chunk 0 (``cpd x size`` lanes) of the etcd history sweep stopped
    after 60 steps on this mesh and saved by rank 0 with its layout."""
    from madsim_tpu_torch import parallel
    from madsim_tpu_torch.engine import checkpoint

    wl, short = _short()
    k = cpd * mesh.size
    partial = parallel.run_sweep_sharded(wl, short, np.arange(k), mesh)
    if mesh.rank == 0:
        checkpoint.save_sweep(partial, path, inflight={"lo": 0, "k": k},
                              mesh_layout=parallel.mesh_layout(mesh, cpd))
    parallel.all_sum(mesh, 0)  # the snapshot exists for every rank
    return host_leaves(partial)


def resumed(mesh, n: int, path: str) -> dict:
    """The etcd history sweep of seeds ``0..n-1`` through
    ``run_sweep_sharded_pipelined``: straight, and resumed from the
    snapshot at ``path`` at its layout's global chunk."""
    from madsim_tpu_torch import parallel
    from madsim_tpu_torch.engine import checkpoint, core

    wl, ecfg, summarize = port_case("etcd_hist")
    layout = checkpoint.load_mesh_layout(path)
    like = core.init_sweep(wl, ecfg, np.arange(layout["chunk_size"]), device=mesh.device)
    restored = checkpoint.load_sweep(path, like)
    inflight = checkpoint.load_inflight(path)
    seeds = np.arange(n)
    straight = parallel.run_sweep_sharded_pipelined(
        wl, ecfg, seeds, summarize, mesh=mesh, chunk_size=layout["chunk_size"])
    again = parallel.run_sweep_sharded_pipelined(
        wl, ecfg, seeds, summarize, mesh=mesh, chunk_size=layout["chunk_size"],
        resume_from=(restored, inflight))
    return {"layout": layout, "straight": json.dumps(straight, sort_keys=True),
            "resumed": json.dumps(again, sort_keys=True)}


# -- explore ------------------------------------------------------------------


def _amnesia():
    from madsim_tpu_torch.engine.faults import FaultSpec
    from madsim_tpu_torch.explore.targets import amnesia_raft_target

    return amnesia_raft_target(**AMNESIA), FaultSpec(**AMNESIA_BASE)


def campaign(mesh, ccfg_fields: dict, report_path: str, ckpt_dir=None) -> bytes:
    """``run_campaign`` of the amnesia target on this mesh; the report's
    bytes (rank 0 wrote them)."""
    from madsim_tpu_torch.explore import CampaignConfig, run_campaign

    target, base = _amnesia()
    run_campaign(target, base, CampaignConfig(**ccfg_fields), report_path=report_path,
                 ckpt_dir=ckpt_dir, mesh=mesh)
    from madsim_tpu_torch.parallel import all_sum

    all_sum(mesh, 0)  # rank 0 has written the report
    with open(report_path, "rb") as f:
        return f.read()


def grid(mesh, ccfg_fields: dict, specs: list) -> list:
    """``sweep_candidate_grid`` summaries of FaultSpec field dicts."""
    from madsim_tpu_torch.engine.faults import FaultSpec
    from madsim_tpu_torch.explore import CampaignConfig, sweep_candidate_grid, target_envelope

    target, base = _amnesia()
    return sweep_candidate_grid(
        target, [FaultSpec(**s) for s in specs], CampaignConfig(**ccfg_fields),
        target_envelope(target, base), mesh=mesh)


def curve(mesh, counts, seeds_total: int, cpd: int) -> dict:
    """``checked_sweep_curve`` of the smoke amnesia gate, unwarmed."""
    from madsim_tpu_torch.explore import checked_sweep_curve
    from madsim_tpu_torch.explore.targets import amnesia_gate

    target, base = amnesia_gate(smoke=True)
    return checked_sweep_curve(target, base, device_counts=tuple(counts),
                               seeds_total=seeds_total, chunk_per_device=cpd,
                               warm_seeds=0, mesh=mesh)


def campaign_metrics(mesh, n_devices: int, ccfg_fields: dict, report_path: str,
                     ckpt_dir=None) -> dict:
    """``sharded_campaign`` on the first ``n_devices`` ranks."""
    from madsim_tpu_torch.explore import CampaignConfig, sharded_campaign

    target, base = _amnesia()
    return sharded_campaign(target, base, CampaignConfig(**ccfg_fields), n_devices,
                            report_path=report_path, ckpt_dir=ckpt_dir, mesh=mesh)


def rank_pid(mesh) -> tuple:
    return mesh.rank, mesh.size, mesh.backend, os.getpid()


# -- the 4,096-seed matrix (slow) ------------------------------------------------


def matrix_leaves(mesh, n: int, cpd: int) -> list:
    """The reference matrix test's raft sweep (1 s, 8,000 steps) of seeds
    ``0..n-1``, chunked at ``cpd`` lanes per rank."""
    from madsim_tpu_torch import parallel
    from madsim_tpu_torch.engine.rng import prob_to_q32
    from madsim_tpu_torch.models import raft

    cfg = raft.RaftConfig(**RAFT, loss_q32=prob_to_q32(LOSS))
    ecfg = raft.engine_config(cfg, queue_capacity=32, time_limit_ns=1_000_000_000,
                              max_steps=8_000)
    return host_leaves(parallel.run_sweep_sharded_chunked(
        raft.workload(cfg), ecfg, np.arange(n), mesh, chunk_per_device=cpd))


def matrix_checked(mesh, n: int, cpd: int) -> str:
    """The reference matrix test's checked etcd sweep (128 history rows,
    500 ms), as JSON."""
    from madsim_tpu_torch.models import etcd
    from madsim_tpu_torch.oracle.screen import checked_sweep

    cfg = etcd.EtcdConfig(hist_slots=128)
    ecfg = etcd.engine_config(cfg, time_limit_ns=500_000_000, max_steps=6_000)
    return json.dumps(checked_sweep(
        etcd.workload(cfg), ecfg, np.arange(n), etcd.history_spec(), etcd.sweep_summary,
        mesh=mesh, chunk_per_device=cpd), sort_keys=True)


def host_phase_calls(mesh, n: int, cpd: int) -> tuple:
    """The checked stale-read etcd sweep through
    ``run_sweep_sharded_pipelined`` with a host phase that counts its
    calls: (the report as JSON, each rank's call count in rank order)."""
    import torch

    from madsim_tpu_torch.models import etcd
    from madsim_tpu_torch.oracle.screen import history_host_work, screen_sweep
    from madsim_tpu_torch.parallel.mesh import gather_rows, run_sweep_sharded_pipelined

    wl, ecfg, summarize = port_case("etcd_stale")
    spec = etcd.history_spec()
    inner = history_host_work(spec)
    calls = [0]

    def host_work(final, **kw):
        calls[0] += 1
        return inner(final, **kw)

    totals = run_sweep_sharded_pipelined(
        wl, ecfg, np.arange(n), summarize, mesh=mesh, host_work=host_work,
        screen=lambda final: screen_sweep(final, spec, mesh=mesh), chunk_per_device=cpd)
    mine = torch.tensor([calls[0]], dtype=torch.int64, device=mesh.device)
    return json.dumps(totals, sort_keys=True), gather_rows(mesh, mine).cpu().tolist()


def race_leases(root: str, name: str, barrier, results) -> None:
    """A process racing its peer for the leases of units 0-3 of the
    port's store at ``root`` (not a rank job: the store test spawns it)."""
    from madsim_tpu_torch.explore.store import CorpusStore

    st = CorpusStore(root, worker=name, ttl_s=60)
    barrier.wait()
    results.put((name, [u for u in range(4) if st.try_lease(u) is not None]))


def steered(mesh, seeds_per_round: int, budget: int, recorded: int, families,
            report_path: str, trace_path: str) -> tuple:
    """``run_steered(mesh=)`` of the raft steer gate at pipeline 2 (rank 0
    writes the files): its records and decision trace as sorted JSON."""
    from madsim_tpu_torch import explore

    target, base = explore.steer_gate(smoke=True)
    ccfg = explore.CampaignConfig(rounds=999, seeds_per_round=seeds_per_round, campaign_seed=7,
                                  max_recorded_seeds=recorded, scheduler="bandit")
    scfg = explore.SteerConfig(families=tuple(families), escalate_seeds=8, kill_plays=1,
                               budget_events=budget)
    res = explore.run_steered(target, base, ccfg, scfg, report_path=report_path,
                              trace_path=trace_path, mesh=mesh)
    return json.dumps(res.records, sort_keys=True), json.dumps(res.decisions, sort_keys=True)


# the checked sweep with a telemetry handle (tests/test_torch_obs_drivers.py)
MESH_TELEMETRY = dict(seeds=100, chunk_per_device=16)


def checked_telemetry(mesh, tmp: str):
    """On every rank: the stale-read checked etcd sweep on the mesh with a
    telemetry handle of the rank's own; (report JSON, record) of the
    rank."""
    from madsim_tpu_torch import obs
    from madsim_tpu_torch.models import etcd
    from madsim_tpu_torch.oracle import screen

    from _torch_obs_record import RUN_ID, record

    cfg = etcd.EtcdConfig(hist_slots=48, bug_stale_read=True)
    ecfg = etcd.engine_config(cfg, time_limit_ns=1_000_000_000)
    jpath = os.path.join(tmp, f"rank{mesh.rank}.jsonl")
    tel = obs.Telemetry(journal=jpath, run_id=RUN_ID)
    report = screen.checked_sweep(
        etcd.workload(cfg), ecfg, np.arange(MESH_TELEMETRY["seeds"], dtype=np.int64),
        etcd.history_spec(), etcd.sweep_summary, mesh=mesh,
        chunk_per_device=MESH_TELEMETRY["chunk_per_device"], telemetry=tel)
    tel.close()
    return json.dumps(report, sort_keys=True), record(obs, tel, jpath)
