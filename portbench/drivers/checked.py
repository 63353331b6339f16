"""The ``checked`` driver: ``oracle.checked_sweep`` on the pipelined chunk
driver (``engine.checkpoint.run_sweep_pipelined``): each chunk swept, its
every lane screened on the card (``oracle.screen.screen_sweep``), the
suspects decoded, deduplicated and checked by WGL over the checker's
process pool, and the verdicts merged into the report.

The window opens after set-up and calls ``checked_sweep`` on one fresh
chunk at a time until ``--seconds`` have passed; the call in flight then
runs to its end, its host phase drained, and that time counts: a check
put off is paid for before the window closes. The harness's
``summarize`` is the model's ``sweep_summary``, which also gathers the
lanes handed to the reference.

Traffic keys: ``lanes``, ``seed_stride``, ``sample`` (as ``chunked``).
"""

from __future__ import annotations

import importlib
import time

import numpy as np

from portbench import harness


class _Collector:
    """The duck-typed ``telemetry=`` the drivers record through, in memory
    (no scrape server)."""

    tracer = None

    def __init__(self):
        self.observed: dict = {}

    def observe(self, name, value, help="", **labels):
        self.observed.setdefault(name, []).append(float(value))

    def count(self, name, value=1, help="", **labels):
        pass

    def gauge(self, name, value, help="", **labels):
        pass

    def event(self, kind, **fields):
        pass

    def event_mix(self, summary, prefix="engine"):
        pass


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    from madsim_tpu_torch.engine import core, cuda_queue
    from madsim_tpu_torch.oracle import check, history, screen

    cfg = ctx.config
    chk = cfg["check"]
    mod = importlib.import_module(f"madsim_tpu_torch.models.{cfg['model']}")
    wcfg = getattr(mod, cfg["config_class"])(**cfg["fields"])
    wl, ecfg = mod.workload(wcfg), mod.engine_config(wcfg, **cfg["engine"])
    spec = mod.history_spec()
    dev = ctx.device
    cuda = torch.device(dev).type == "cuda"
    sample = harness.LaneSample(int(ctx.traffic["sample"]), ctx.rng())
    workers = int(chk["workers"])

    # set-up: the checker's pool, then one step, the screen and the
    # summary on the first chunk's lanes (loads pop_min and every kernel
    # the window runs); that state is dropped
    empty = history.History(seed=0, ops=(), overflow=False, rows=0)
    check.check_histories([empty] * (4 * workers), spec, workers=workers)
    warm = core.init_sweep(wl, ecfg, ctx.chunk_seeds(0), device=dev)
    warm = core.step_batch(wl, ecfg, warm, device=dev)
    screen.screen_sweep(warm, spec)
    mod.sweep_summary(warm)
    del warm
    if cuda:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    else:
        setup_peak = 0

    harness.pin_host(dev)
    chunk = 0
    reports = []

    def summarize(final):
        sample.take(final, ecfg.max_steps, longest=final.hist_len.argmax(),
                    verdicts=_verdicts(reports, len(reports)))
        return mod.sweep_summary(final)

    collector = _Collector() if ctx.trace else None
    chunks = []  # (pop_min launches = steps, seconds since the window opened) of each call
    t_open = time.perf_counter()
    while True:
        launches = cuda_queue.pop_min_decision.launches
        reports.append(screen.checked_sweep(
            wl, ecfg, ctx.chunk_seeds(chunk), spec, summarize, chunk_size=ctx.lanes, workers=workers,
            max_states=int(chk["max_states"]), max_recorded=ctx.lanes,
            telemetry=collector, device=dev))
        chunk += 1
        chunks.append((cuda_queue.pop_min_decision.launches - launches,
                       time.perf_counter() - t_open))
        if time.perf_counter() - t_open >= ctx.seconds:
            break
    t_close = time.perf_counter()
    peak = 0
    if cuda:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    swept = chunk * ctx.lanes
    screened = sum(r["hist_screened"] for r in reports)
    suspects = sum(r["hist_suspects"] for r in reports)
    ctx.records.update({
        "t_open": t_open,
        "window": {"wall_s": t_close - t_open, "seeds": swept, "chunks": chunk},
        "report": {"hist_screened": screened, "hist_suspects": suspects,
                   "hist_violations": sum(r["hist_violations"] for r in reports)},
        "memory": {"window_peak_bytes": peak},
        "chunks": chunks,
    })
    if collector is not None:
        ctx.records["telemetry"] = collector.observed
    if ctx.trace:
        # a state mid-chunk at the window's width: the next chunk's seeds,
        # one sync block of steps in
        state = core.init_sweep(wl, ecfg, ctx.chunk_seeds(chunk), device=dev)
        for _ in range(core.CHECK_EVERY):
            state = core.step_batch(wl, ecfg, state, device=dev)
        rec, state = harness.profile_steps(wl, ecfg, state, dev)
        rec["handler_s"] = harness.profile_handler(wl, state, dev)
        ctx.records["profile"] = rec
        del state
    check.shutdown_pools()
    groups = sample.to_host()
    return harness.Outcome(
        end_to_end={"checked_seeds_per_s": screened / (t_close - t_open)},
        groups=groups,
        attempted=swept,
        memory_peak_bytes=max(setup_peak, peak),
        checks={"lanes_unscreened": {"value": swept - screened, "limit": 0}},
    )


def _verdicts(reports: list, call: int):
    """The program's verdict on each sampled lane of the call-th
    ``checked_sweep``'s chunk, read from that call's report once it has
    returned: 1 listed as violating, 0 not. The call records every
    violating seed of its chunk (``max_recorded`` is the chunk's width),
    so a lane left out of the list is one the program calls clean."""
    def read(seeds):
        listed = set(int(s) for s in reports[call].get("hist_violating_seeds", []))
        return np.array([int(int(s) in listed) for s in seeds], dtype=np.int64)

    return read
