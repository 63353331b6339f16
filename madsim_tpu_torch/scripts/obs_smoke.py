"""Observability smoke (counterpart of ``scripts/obs_smoke.py``).

End-to-end assertions of the telemetry plane on ``--device`` (default
CUDA), small enough for a smoke gate, producing one Perfetto-loadable
trace file as the run's artifact:

1. out-of-band: the pipelined checked sweep and the streaming checked
   sweep each produce equal report dicts with telemetry on and off (the
   process-level byte comparison lives in ``check_determinism``);
2. trace spans: the saved Chrome-trace JSON has named "device" and
   "host" tracks, a device span overlaps a host span (the sweep of chunk
   N brackets the host check of chunk N-1), and the stream pool's
   occupancy rides along as counter samples;
3. journal: the run's JSONL stream has run_start/run_end plus per-chunk
   and per-flush events, all carrying the same run ID;
4. exposition: the opt-in localhost HTTP endpoint serves the registry in
   Prometheus text format while the sweep runs;
5. event mix: a raft sweep with the opt-in device-side event-mix plane
   lands per-kind counters in ``engine_events_by_kind_total``, and the
   default-config report stays free of the "event_mix" key.

Usage, from the repository root:
    python -m madsim_tpu_torch.scripts.obs_smoke [out_dir] [--device D]   (default ./obs_smoke_out)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.request

from . import _cli


def _spans(events, track_tid):
    return [e for e in events if e.get("ph") == "X" and e.get("tid") == track_tid]


def _overlaps(a, b) -> bool:
    return max(a["ts"], b["ts"]) < min(a["ts"] + a["dur"], b["ts"] + b["dur"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="obs_smoke")
    ap.add_argument("out_dir", nargs="?", default="obs_smoke_out")
    _cli.add_device(ap)
    args = ap.parse_args(argv)
    dev = _cli.device(args, ap.prog)

    import numpy as np

    from .. import obs
    from ..engine.checkpoint import run_sweep_pipelined
    from ..models import etcd, raft
    from ..obs import read_journal
    from ..oracle.screen import checked_sweep

    out_dir = args.out_dir
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "trace.json")
    journal_path = os.path.join(out_dir, "journal.jsonl")
    for p in (trace_path, journal_path):
        if os.path.exists(p):
            os.remove(p)

    cfg = etcd.EtcdConfig(hist_slots=128, bug_stale_read=True)
    ecfg = etcd.engine_config(cfg, time_limit_ns=1_000_000_000, max_steps=6_000)
    wl = etcd.workload(cfg)
    spec = etcd.history_spec()
    seeds = np.arange(128, dtype=np.int64)
    kw = dict(chunk_size=32, workers=0, device=dev)

    # warm both drivers so the traced region shows steady-state
    # pipelining, not the kernel's first load
    checked_sweep(wl, ecfg, seeds, spec, etcd.sweep_summary, **kw)
    checked_sweep(wl, ecfg, seeds, spec, etcd.sweep_summary, driver="stream", **kw)

    telem = obs.Telemetry(journal=journal_path, trace=trace_path, http_port=0)
    run_id = telem.run_id

    # -- leg 1: pipelined chunked checked sweep (device/host overlap) --
    piped = checked_sweep(wl, ecfg, seeds, spec, etcd.sweep_summary,
                          telemetry=telem, **kw)
    piped_off = checked_sweep(wl, ecfg, seeds, spec, etcd.sweep_summary, **kw)
    _cli.check(piped == piped_off, "telemetry changed the pipelined report")
    print(f"pipelined report out-of-band: OK "
          f"({piped['hist_violations']} violations)")

    # -- leg 2: streaming checked sweep (refill cadence) ---------------
    streamed = checked_sweep(wl, ecfg, seeds, spec, etcd.sweep_summary,
                             driver="stream", telemetry=telem, **kw)
    streamed_off = checked_sweep(wl, ecfg, seeds, spec, etcd.sweep_summary,
                                 driver="stream", **kw)
    _cli.check(streamed == streamed_off, "telemetry changed the stream report")
    print("stream report out-of-band: OK")

    # -- leg 3: the opt-in device-side event-mix plane -----------------
    rcfg = raft.RaftConfig(num_nodes=3, crashes=1, event_mix=True)
    recfg = raft.engine_config(rcfg, time_limit_ns=500_000_000)
    mixed = run_sweep_pipelined(
        raft.workload(rcfg), recfg, np.arange(64, dtype=np.int64),
        raft.sweep_summary, chunk_size=32, telemetry=telem, device=dev,
    )
    _cli.check("event_mix" in mixed and len(mixed["event_mix"]) == raft.N_KINDS,
               f"event_mix missing or of the wrong length: {mixed.get('event_mix')}")
    _cli.check(sum(mixed["event_mix"]) > 0, "event-mix plane counted nothing")
    plain_cfg = raft.RaftConfig(num_nodes=3, crashes=1)
    plain = run_sweep_pipelined(
        raft.workload(plain_cfg),
        raft.engine_config(plain_cfg, time_limit_ns=500_000_000),
        np.arange(64, dtype=np.int64), raft.sweep_summary, chunk_size=32, device=dev,
    )
    _cli.check("event_mix" not in plain, "default report grew an event_mix key")
    by_kind = telem.registry.get("engine_events_by_kind_total", kind="0")
    _cli.check(bool(by_kind) and by_kind > 0, "event-mix counters missing from registry")
    print(f"event-mix plane: OK (mix={mixed['event_mix']})")

    # -- leg 4: live Prometheus exposition -----------------------------
    body = urllib.request.urlopen(telem.server.url, timeout=5).read().decode()
    for needle in ("sweep_chunk_seconds_bucket", "stream_rounds_total",
                   "oracle_screened_total", "engine_events_by_kind_total"):
        _cli.check(needle in body, f"exposition missing {needle}")
    print(f"exposition endpoint: OK ({telem.server.url}, "
          f"{len(body.splitlines())} lines)")

    telem.close()

    # -- leg 5: the trace artifact -------------------------------------
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    tracks = {
        e["args"]["name"]: e["tid"]
        for e in events
        if e.get("ph") == "M" and e.get("name") == "thread_name"
    }
    _cli.check("device" in tracks and "host" in tracks, f"tracks: {tracks}")
    dev_spans = _spans(events, tracks["device"])
    host = _spans(events, tracks["host"])
    _cli.check(bool(dev_spans and host),
               f"empty tracks: {len(dev_spans)} device, {len(host)} host")
    overlapped = sum(1 for h in host if any(_overlaps(h, d) for d in dev_spans))
    _cli.check(overlapped > 0, "no device/host phase overlap visible in trace")
    occ_samples = [
        e for e in events
        if e.get("ph") == "C" and e.get("name") == "stream occupancy"
    ]
    _cli.check(len(occ_samples) >= 2, "no refill-cadence counter samples")
    rounds = [e for e in dev_spans if e["name"].startswith("round ")]
    _cli.check(bool(rounds), "no stream round spans on the device track")
    print(
        f"trace: OK ({len(dev_spans)} device spans, {len(host)} host spans, "
        f"{overlapped} host spans overlap device work, "
        f"{len(occ_samples)} occupancy samples) -> {trace_path}"
    )

    # -- leg 6: the run journal ----------------------------------------
    recs = read_journal(journal_path)
    kinds = [r["kind"] for r in recs]
    _cli.check(kinds[0] == "run_start" and kinds[-1] == "run_end", str(kinds[:3]))
    _cli.check("chunk" in kinds and "flush" in kinds, str(sorted(set(kinds))))
    _cli.check(all(r["run"] == run_id for r in recs), "run ID drifted")
    print(f"journal: OK ({len(recs)} events, run {run_id}) -> {journal_path}")

    print("obs smoke: ALL OK "
          f"(backend={_cli.device_name(dev)}); load {trace_path} in "
          "https://ui.perfetto.dev to see the overlap")
    return 0


if __name__ == "__main__":
    sys.exit(main())
