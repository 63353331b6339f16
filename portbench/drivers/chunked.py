"""The ``chunked`` driver: chunk after chunk of fresh seeds through the
port's sweep entry, ``core.init_sweep`` then ``core.drive`` (each step
``core.step_batch``, one pop-min kernel launch), and the model's
``sweep_summary`` on each finished chunk, as a user's sweep runs them.

The window's clock and its event count are read at ``drive``'s own
live-count syncs, through its ``live=`` hook, which also reads the sum
of the lanes' ``ctr`` in the same copy, so the harness adds no sync. The
window opens at the first sync after the warm-up step and closes at the
first sync after ``--seconds``; the chunk then in flight stops there and
its progress counts.

Traffic keys: ``lanes`` (seeds per chunk), ``seed_stride`` (a run's seeds
start at ``--seed`` times it), ``sample`` (lanes per chunk handed to the
reference, besides each chunk's longest run).
"""

from __future__ import annotations

import importlib
import time

from portbench import harness


class _Window:
    """The ``live=`` hook: one device-to-host copy per sync (live lanes,
    events of the chunk so far), the window's clock and its counts."""

    def __init__(self, seconds: float, check_every: int):
        self.seconds = seconds
        self.check_every = check_every
        self.t_open = None
        self.t_close = None
        self.events_done = 0  # events of finished chunks
        self.events_chunk = 0  # events of the chunk in flight, last sync
        self.events_open = 0
        self.steps_open = 0
        self.steps = 0  # steps since the warm-up, all chunks
        self.chunk_steps = 0  # steps of the chunk in flight
        self.first_call = True

    def start_chunk(self, warm_steps: int = 0) -> None:
        self.events_done += self.events_chunk
        self.events_chunk = 0
        self.chunk_steps = warm_steps
        self.first_call = True

    def __call__(self, state) -> int:
        import torch

        live, events = torch.stack(
            [(~state.done).sum(), state.ctr.sum(dtype=torch.int64)]).tolist()
        now = time.perf_counter()
        if not self.first_call:
            self.steps += self.check_every
            self.chunk_steps += self.check_every
        self.first_call = False
        self.events_chunk = int(events)
        if self.t_open is None:
            self.t_open = now
            self.events_open = self.events_done + self.events_chunk
            self.steps_open = self.steps
        elif now - self.t_open >= self.seconds:
            self.t_close = now
            return 0
        return int(live)

    @property
    def events(self) -> int:
        return self.events_done + self.events_chunk - self.events_open


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    from madsim_tpu_torch.engine import core

    cfg = ctx.config
    mod = importlib.import_module(f"madsim_tpu_torch.models.{cfg['model']}")
    wcfg = getattr(mod, cfg["config_class"])(**cfg["fields"])
    wl, ecfg = mod.workload(wcfg), mod.engine_config(wcfg, **cfg["engine"])
    dev = ctx.device
    cuda = torch.device(dev).type == "cuda"
    sample = harness.LaneSample(int(ctx.traffic["sample"]), ctx.rng())

    # set-up: the first chunk, one warm-up step and the summary's kernels
    # (loads pop_min, built into the checkout on a run's first call there,
    # and every kernel the window runs)
    state = core.init_sweep(wl, ecfg, ctx.chunk_seeds(0), device=dev)
    state = core.step_batch(wl, ecfg, state, device=dev)
    mod.sweep_summary(state)
    if cuda:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    else:
        setup_peak = 0
    harness.pin_host(dev)
    window = _Window(ctx.seconds, core.CHECK_EVERY)
    window.start_chunk(warm_steps=1)
    chunk = 0
    chunks = []  # (steps, seconds since the window opened) of each finished chunk
    while True:
        state = core.drive(wl, ecfg, state, live=window)
        if window.t_close is not None and not bool(state.done.all()):
            # the window closed on the chunk in flight: its lanes as they are
            sample.take(state, window.chunk_steps, longest=state.ctr.argmax())
            break
        mod.sweep_summary(state)
        sample.take(state, window.chunk_steps, longest=state.ctr.argmax())
        chunks.append((window.chunk_steps, time.perf_counter() - window.t_open))
        if window.t_close is not None:
            break
        chunk += 1
        window.start_chunk()
        state = core.init_sweep(wl, ecfg, ctx.chunk_seeds(chunk), device=dev)
    wall = window.t_close - window.t_open
    peak = 0
    if cuda:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    steps = window.steps - window.steps_open
    ctx.records.update({
        "t_open": window.t_open,
        "window": {"wall_s": wall, "steps": steps, "events": window.events,
                   "lanes": ctx.lanes},
        "chunks": chunks,
        "memory": {"window_peak_bytes": peak},
    })
    if ctx.trace:
        rec, state = harness.profile_steps(wl, ecfg, state, dev)
        rec["handler_s"] = harness.profile_handler(wl, state, dev)
        ctx.records["profile"] = rec
    groups = sample.to_host()
    del state, sample
    return harness.Outcome(
        end_to_end={"events_per_s": window.events / wall},
        groups=groups,
        attempted=(chunk + 1) * ctx.lanes,
        memory_peak_bytes=max(setup_peak, peak),
    )
