"""Port parity: the telemetry plane (``madsim_tpu_torch.obs``) against
``madsim_tpu.obs``.

Every test of the reference's ``tests/test_obs.py`` runs as a case
through both packages (``_torch_ref_tests``): the registry, the journal
with its torn final line at every offset, the HTTP endpoint, the
``Telemetry`` handle, the heartbeat, ``bind_runtime_metrics`` against
each package's own host runtime, and the tracers' Chrome-trace shapes.
Beside them, one recorded sequence goes into both packages and comes out
as the same Prometheus text, the same journal lines (wall timestamps
aside), the same snapshot and the same span-tracer events (times aside).
"""

import json
import urllib.request

import pytest

from madsim_tpu import obs as robs
from madsim_tpu import tracing as rtracing
from madsim_tpu_torch import obs as pobs
from madsim_tpu_torch import tracing as ptracing

import _torch_ref_tests as ref_tests

OBS = "test_obs"


@pytest.mark.parametrize("case", ref_tests.cases(OBS))
def test_reference_obs_case(case, tmp_path):
    ref_tests.run_case(OBS, case, tmp_path)


def _record_sequence(obs, tmp_path, tag):
    """One fixed sequence of every recorder into a handle with a
    journal and a trace; (handle, journal path, trace path)."""
    jpath, tpath = tmp_path / f"{tag}.jsonl", tmp_path / f"{tag}.json"
    t = obs.Telemetry(journal=str(jpath), trace=str(tpath), run_id="0123456789abcdef")
    t.count("sweep_chunks_total")
    t.count("sweep_seeds_done_total", 32, help="seeds merged so far")
    t.count("kafka_frames_total", help="request frames served", api="Produce")
    t.count("kafka_frames_total", 3, help="request frames served", api="Fetch")
    t.count("weird_total", help='a "quoted"\nhelp \\ text', path='a"b\\c\nd')
    t.gauge("stream_occupancy", 0.875, help="pool occupancy")
    t.gauge("stream_queue_depth", 96)
    t.gauge("big", 1e17)
    for v in (0.0001, 0.004, 0.3, 2.0, 70.0):
        t.observe("sweep_chunk_seconds", v, help="device phase per chunk")
    t.observe("kafka_api_seconds", 0.02, api="Produce")
    t.event("chunk", lo=0, k=32)
    t.event("flush", lo=32, k=16, note="x")
    with t.span("device chunk lo=0", track="device", lo=0):
        with t.span("host flush lo=0", track="host"):
            pass
    t.sample("stream occupancy", occupancy=0.5, queue_depth=7)
    t.event_mix({"event_mix": [3, 0, 7, 1]})
    return t, jpath, tpath


def test_one_sequence_renders_the_same_bytes(tmp_path):
    out = {}
    for tag, obs in (("reference", robs), ("port", pobs)):
        t, jpath, tpath = _record_sequence(obs, tmp_path, tag)
        text = obs.render_prometheus(t.registry)
        snap = t.registry.snapshot()
        t.close()
        journal = [{k: v for k, v in r.items() if k != "ts"} for r in obs.read_journal(str(jpath))]
        trace = json.loads(tpath.read_text())["traceEvents"]
        shape = [(e["ph"], e["name"], e.get("tid"), e.get("args")) for e in trace]
        out[tag] = (text, snap, journal, shape)
    ref, port = out["reference"], out["port"]
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert [r["kind"] for r in port[2]] == ["run_start", "chunk", "flush", "run_end"]
    assert port[3] == ref[3]
    assert 'weird_total{path="a\\"b\\\\c\\nd"} 1' in port[0]
    assert 'sweep_chunk_seconds_bucket{le="+Inf"} 5' in port[0]


@pytest.mark.parametrize("cut", ["mid-record", "no-newline", "empty-tail"])
def test_journals_of_both_packages_read_alike(tmp_path, cut):
    """A journal either package writes is read the same by both, torn
    tails included (every offset of the last record)."""
    path = tmp_path / "j.jsonl"
    j = pobs.Journal(str(path), run_id="f" * 16)
    for i in range(3):
        j.write("chunk", lo=32 * i, k=32)
    j.close()
    data = path.read_bytes()
    last = data.rstrip(b"\n").rfind(b"\n") + 1
    offsets = {"mid-record": range(last + 1, len(data) - 1),
               "no-newline": [len(data) - 1], "empty-tail": [len(data)]}[cut]
    for off in offsets:
        path.write_bytes(data[:off])
        ref, port = robs.read_journal(str(path)), pobs.read_journal(str(path))
        assert list(port) == list(ref) and port.truncated == ref.truncated
        assert type(port).__name__ == type(ref).__name__ == "JournalRecords"


def test_http_endpoints_serve_the_same_text():
    bodies = []
    for obs in (robs, pobs):
        t = obs.Telemetry(http_port=0)
        try:
            t.count("hits_total", 2, help="hits", route="/a")
            t.observe("lat_seconds", 0.3)
            assert t.server.host == "127.0.0.1"
            with urllib.request.urlopen(t.server.url, timeout=5) as r:
                assert r.headers["Content-Type"] == "text/plain; version=0.0.4; charset=utf-8"
                bodies.append(r.read())
        finally:
            t.close()
    assert bodies[0] == bodies[1]
    assert b'hits_total{route="/a"} 2' in bodies[1]


def test_runtime_metrics_of_each_package_bind_alike():
    """``bind_runtime_metrics`` of each package over its own host
    runtime's ``RuntimeMetrics``, mid-run, renders the same text."""
    import madsim_tpu as R
    import madsim_tpu_torch as P

    texts = []
    for ms, obs in ((R, robs), (P, pobs)):
        rt = ms.Runtime(seed=9)

        async def main(ms=ms, obs=obs):
            h = ms.current_handle()
            for name in ("svc", "db"):
                node = h.create_node().name(name).build()

                async def forever(ms=ms):
                    await ms.sleep(1000.0)

                node.spawn(forever())
            await ms.sleep(0.1)
            r = obs.Registry()
            obs.bind_runtime_metrics(r, h.metrics())
            return obs.render_prometheus(r)

        texts.append(rt.block_on(main()))
    assert texts[0] == texts[1]
    assert "madsim_runtime_tasks_by_spawn_site" in texts[1]


def test_span_tracers_give_the_same_events():
    """The same spans, instants and counter samples give the same
    Chrome-trace events in both packages (wall times aside; a span given
    its own times keeps them)."""
    shapes = []
    for tracing in (rtracing, ptracing):
        st = tracing.SpanTracer()
        with st.span("device chunk lo=0", track="device", args={"k": 32}):
            with st.span("host flush lo=0", track="host"):
                pass
        st.complete("round 1", 10.0, 5.0, track="device")
        st.instant("snapshot", track="host")
        st.counter("stream occupancy", occupancy=0.875, queue=96)
        events = json.loads(st.to_json())["traceEvents"]
        shapes.append([e if e["name"] == "round 1" else
                       {k: v for k, v in e.items() if k not in ("ts", "dur")} for e in events])
    assert shapes[0] == shapes[1]


def test_heartbeat_lines_agree():
    import io

    lines = []
    for obs in (robs, pobs):
        r = obs.Registry()
        out = io.StringIO()
        r.counter("stream_seeds_done_total").inc(0)
        r.gauge("stream_occupancy").set(0.5)
        hb = obs.Heartbeat(r, total_seeds=1000, prefix="stream", out=out)
        lines.append(hb.tick(force=True))
    assert lines[0] == lines[1] == "[hb] 0/1000 seeds  0 seeds/s  occ 0.500  ETA ?"
