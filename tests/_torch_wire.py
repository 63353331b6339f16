"""The wire programs of the port's parity tests, written once over a
package module (``madsim_tpu`` or ``madsim_tpu_torch``):

- ``wire_load(ms)``: the package's load-rig driver, the port's
  ``madsim_tpu_torch.wire_load`` or the reference's
  ``scripts/wire_load.py`` (loaded as the module ``_ref_wire_load``);
- ``determinism_bytes(ms, kind, seed, telemetry)``: the determinism
  report of ``wire_load --determinism`` as the bytes it writes;
- ``s3_transcript(ms, seed)``: the (request, clock, response) transcript
  of the determinism mode's S3 session, with the rig's bucket made
  first so that its multipart uploads complete, recorded by the
  package's ``S3Rest`` behind its live ``WireServer``;
- ``fuzz_digests(fuzz_ms, seeds, ops, client_ms, wire_ms)``: the Kafka
  wire-vs-broker differential's per-seed digests, ``fuzz_ms``'s
  ``fuzz_seed`` driving ``client_ms``'s ``ProbeClient`` through a
  ``LoopbackTransport`` into ``wire_ms``'s ``KafkaWire``;
- ``fuzz_tcp_digests(ms, seeds, ops)``: the same over localhost TCP
  into the package's ``WireServer``.

This module imports neither package.
"""

from __future__ import annotations

import asyncio
import importlib
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sub(ms, name: str):
    return importlib.import_module(f"{ms.__name__}.{name}")


def wire_load(ms):
    if ms.__name__ != "madsim_tpu":
        return sub(ms, "wire_load")
    mod = sys.modules.get("_ref_wire_load")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "_ref_wire_load", os.path.join(REPO, "scripts", "wire_load.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules["_ref_wire_load"] = mod
        spec.loader.exec_module(mod)
    return mod


def report_bytes(report: dict) -> bytes:
    """A report as ``wire_load`` writes it."""
    return (json.dumps(report, sort_keys=True, indent=1) + "\n").encode()


def determinism_bytes(ms, kind: str, seed: int, telemetry: bool) -> bytes:
    wl = wire_load(ms)
    return report_bytes(asyncio.run(wl._determinism_async(kind, seed, telemetry)))


def s3_transcript(ms, seed: int) -> list:
    wl = wire_load(ms)

    async def main():
        cluster = wl.loadgen.Cluster(kafka_clock=wl._Counter(), s3_clock=wl._Counter(),
                                     telemetry=False, kafka_advertised=("127.0.0.1", 9092))
        addrs = await cluster.start()
        try:
            # the multipart uploads of the session write to the rig's bucket
            setup = wl.loadgen._HttpClient(*addrs["s3"])
            await setup.connect()
            await setup.request("PUT", f"/{wl.loadgen.BUCKET}")
            setup.close()
            await wl._det_s3(addrs["s3"], seed)
            return list(cluster.s3.rest.recorder)
        finally:
            await cluster.stop()

    return asyncio.run(main())


def fuzz_digests(fuzz_ms, seeds, ops: int, client_ms=None, wire_ms=None) -> list:
    fuzz = sub(fuzz_ms, "kafka.fuzz")
    probe = sub(client_ms or fuzz_ms, "kafka.probe")
    wire = sub(wire_ms or client_ms or fuzz_ms, "kafka.wire")

    async def main():
        return [await fuzz.fuzz_seed(s, probe.ProbeClient(probe.LoopbackTransport(wire.KafkaWire())),
                                     ops=ops) for s in seeds]

    return asyncio.run(main())


def fuzz_tcp_digests(ms, seeds, ops: int) -> list:
    real, fuzz = sub(ms, "real"), sub(ms, "kafka.fuzz")
    probe, wire = sub(ms, "kafka.probe"), sub(ms, "kafka.wire")

    async def main():
        out = []
        for seed in seeds:
            server = wire.WireServer()
            task = real.spawn(server.serve(("127.0.0.1", 0)))
            while server.bound_addr is None:
                if task.done():
                    task.result()
                await real.sleep(0.005)
            client = probe.ProbeClient(await probe.RealTransport.connect(server.bound_addr))
            try:
                out.append(await fuzz.fuzz_seed(seed, client, ops=ops))
            finally:
                client.close()
                task.abort()
        return out

    return real.Runtime().block_on(main())
