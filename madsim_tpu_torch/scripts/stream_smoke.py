"""Streaming sweep service smoke (counterpart of ``scripts/stream_smoke.py``).

End-to-end assertions of the persistent lane pool's contracts on
``--device`` (default CUDA), small enough for a smoke gate:

1. streaming == chunked: ``stream_sweep`` totals equal to
   ``run_sweep_pipelined`` over the same (seeds, chunk_size), on the
   screened etcd checked sweep (screen + WGL host work riding along);
2. refill-schedule invariance: a permuted ``queue_order`` (lanes retire
   and refill in a completely different order) changes nothing;
3. interrupt/resume: stopping after a few rounds into a v9 stream
   snapshot and resuming reproduces the uninterrupted totals exactly;
4. zero builds: a warmed stream over a fresh seed range performs 0
   kernel builds or loads (``engine/compiles.count_compiles``), and
   occupancy stays high (the whole point of continuous refill);
5. telemetry rides along out-of-band: the first leg runs under an
   ``obs.Telemetry`` handle whose registry drives the progress heartbeat
   (seeds done, seeds/s, occupancy, ETA on stderr) — with the totals
   still equal to the uninstrumented chunked run.

Usage, from the repository root:
    python -m madsim_tpu_torch.scripts.stream_smoke [--device D]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

from . import _cli


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stream_smoke")
    _cli.add_device(ap)
    args = ap.parse_args(argv)
    dev = _cli.device(args, ap.prog)

    import numpy as np

    from .. import obs
    from ..engine.checkpoint import run_sweep_pipelined
    from ..engine.compiles import count_compiles
    from ..engine.stream import stream_sweep
    from ..models import etcd
    from ..oracle.screen import history_host_work, screen_sweep

    cfg = etcd.EtcdConfig(hist_slots=128, bug_stale_read=True)
    ecfg = etcd.engine_config(cfg, time_limit_ns=1_000_000_000, max_steps=6_000)
    wl = etcd.workload(cfg)
    spec = etcd.history_spec()
    screen = lambda final: screen_sweep(final, spec)  # noqa: E731
    hw = history_host_work(spec)
    seeds = np.arange(96, dtype=np.int64)
    kw = dict(chunk_size=32, host_work=hw, screen=screen, device=dev)

    t0 = time.perf_counter()
    chunked = run_sweep_pipelined(wl, ecfg, seeds, etcd.sweep_summary, **kw)
    stats: dict = {}
    # the obs-registry heartbeat: the stream driver counts
    # stream_seeds_done_total / sets stream_occupancy as it runs, and the
    # heartbeat prints from those series — the telemetry must not change
    # the report (checked below)
    telem = obs.Telemetry()
    hb = obs.Heartbeat(telem.registry, len(seeds), prefix="stream")
    streamed = stream_sweep(
        wl, ecfg, seeds, etcd.sweep_summary, pool_size=32, round_steps=256,
        stats=stats, telemetry=telem, **kw,
    )
    hb_line = hb.tick(force=True)
    _cli.check(hb_line is not None and f"{len(seeds)}/{len(seeds)}" in hb_line,
               f"heartbeat did not see the registry's seed count: {hb_line!r}")
    _cli.check(streamed == chunked,
               f"stream totals diverge from chunked:\n{streamed}\nvs\n{chunked}")
    print(
        f"stream == chunked: OK ({streamed['hist_violations']} violations, "
        f"{streamed['hist_unique']}/{streamed['hist_suspects']} unique "
        f"suspects, occupancy {stats['occupancy_mean']:.3f} over "
        f"{stats['rounds']} rounds, telemetry out-of-band)"
    )

    order = np.random.default_rng(7).permutation(len(seeds))
    permuted = stream_sweep(
        wl, ecfg, seeds, etcd.sweep_summary, pool_size=32, round_steps=256,
        queue_order=order, **kw,
    )
    _cli.check(permuted == chunked, "permuted refill schedule changed the report")
    print("refill-schedule invariance: OK (permuted queue, same bytes)")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "stream.npz")
        stream_sweep(
            wl, ecfg, seeds, etcd.sweep_summary, pool_size=32,
            round_steps=256, ckpt_path=path, stop_after_rounds=2, **kw,
        )
        _cli.check(os.path.exists(path), "no v9 stream snapshot written")
        resumed = stream_sweep(
            wl, ecfg, seeds, etcd.sweep_summary, pool_size=32,
            round_steps=256, resume_from=path, **kw,
        )
    _cli.check(resumed == chunked, "interrupt/resume changed the totals")
    print("interrupt/resume via v9 snapshot: OK (bit-identical totals)")

    fresh = np.arange(1000, 1000 + 96, dtype=np.int64)
    with count_compiles() as c:
        warm_stats: dict = {}
        stream_sweep(
            wl, ecfg, fresh, etcd.sweep_summary, pool_size=32,
            round_steps=256, stats=warm_stats, **kw,
        )
    _cli.check(c.count == 0, f"{c.count} kernel builds or loads in a warmed stream")
    _cli.check(warm_stats["occupancy_mean"] > 0.5,
               f"pool occupancy collapsed: {warm_stats['occupancy_mean']:.3f}")
    print(
        f"warmed stream: OK (0 kernel builds or loads, occupancy "
        f"{warm_stats['occupancy_mean']:.3f})"
    )
    print(
        f"stream smoke: ALL OK in {time.perf_counter() - t0:.1f}s "
        f"(backend={_cli.device_name(dev)})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
