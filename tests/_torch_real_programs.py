"""The real-mode programs of the port's parity tests and of
``chip_smoke.py`` phase 19 (d): one round trip of each real-mode shim
over localhost, written once over a package module (``madsim_tpu`` or
``madsim_tpu_torch``) and returning what it observed as plain data
(values, error codes, status code names, exception type names; never a
port number or a time), so two packages' runs can be held equal with
``==``.

- ``greeter_real``: the package's ``examples/greeter_real.py`` demo, its
  printed lines without the one naming the bound port;
- ``etcd_roundtrip``: put, get, prefix get, delete, a txn, a watch and
  the ``Unavailable`` of a server whose every request times out;
- ``kafka_roundtrip``: ``real.kafka``'s broker (the genuine Kafka wire
  on the serving core) with create, produce, consume and watermarks;
- ``s3_roundtrip``: bucket, put, get, list and the ``NoSuchKey`` error;
- ``probe_session(client_ms, server_ms)``: ``kafka.probe.ProbeClient``
  of one package against the other's ``kafka.wire.WireServer`` over TCP;
- ``loopback_transcript(client_ms, wire_ms)``: the same session through
  ``LoopbackTransport`` into a ``KafkaWire`` on a fixed clock, returning
  every (request, response) frame's bytes.

``digest`` of each ``SMOKE`` program's outcome, as the JAX package gives
it, is ``madsim_tpu_torch/data/real_outcomes.json``
(``python tests/test_torch_real.py --write``). This module imports
neither package.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import io


def digest(outcome) -> str:
    """The sha256 of an outcome's ``repr`` (plain data: the same text in
    every process)."""
    return hashlib.sha256(repr(outcome).encode()).hexdigest()


def sub(ms, name: str):
    return importlib.import_module(f"{ms.__name__}.{name}")


def example(ms, name: str):
    if ms.__name__ == "madsim_tpu":
        return importlib.import_module(f"examples.{name}")
    return importlib.import_module(f"{ms.__name__}.examples.{name}")


async def _started(real, server):
    """Spawn ``server.serve`` on an ephemeral localhost port; the task
    and ``host:port`` once it is bound."""
    task = real.spawn(server.serve(("127.0.0.1", 0)))
    while server.bound_addr is None:
        if task.done():
            task.result()  # surface the bind failure instead of spinning
        await real.sleep(0.005)
    host, port = server.bound_addr[:2]
    return task, f"{host}:{port}"


def greeter_real(ms) -> list:
    real = sub(ms, "real")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        real.Runtime().block_on(example(ms, "greeter_real").demo())
    return [line for line in out.getvalue().splitlines() if not line.startswith("serving on")]


def etcd_roundtrip(ms) -> dict:
    real = sub(ms, "real")
    etcd = sub(ms, "real.etcd")
    Status = sub(ms, "grpc.status").Status

    async def main():
        task, addr = await _started(real, etcd.Server(etcd.EtcdService()))
        client = await etcd.Client.connect(addr)
        out = {}
        await client.put("k1", "v1")
        await client.put("k2", "v2")
        resp = await client.get("k1")
        out["get"] = [(kv.key_str(), kv.value_str()) for kv in resp.kvs()]
        out["revision"] = resp.header().revision()
        resp = await client.get("k", etcd.GetOptions().with_prefix())
        out["prefix"] = sorted((kv.key_str(), kv.value_str()) for kv in resp.kvs())
        out["deleted"] = (await client.delete("k2")).deleted()
        txn = (etcd.Txn().when([etcd.Compare.value("k1", etcd.CompareOp.EQUAL, "v1")])
               .and_then([etcd.TxnOp.put("k1", "v3")])
               .or_else([etcd.TxnOp.put("k1", "wrong")]))
        out["txn"] = (await client.txn(txn)).succeeded()
        out["after_txn"] = (await client.get("k1")).kvs()[0].value_str()
        watch = await client.watch_client().watch("w", prefix=True)

        async def writer():
            await real.sleep(0.02)
            await client.put("w/a", "1")
            await client.put("w/b", "2")

        w = real.spawn(writer())
        events = []
        for _ in range(2):
            ev = await watch.next()
            events.append((ev.type.name, ev.kv.key_str(), ev.kv.value_str()))
        await w
        watch.cancel()
        out["watch"] = events
        task.abort()

        stalled = etcd.Server(etcd.EtcdService(), timeout_rate=1.0)
        stalled._uniform = lambda a, b: 0.01  # the injected stall, shortened
        task, addr = await _started(real, stalled)
        client = await etcd.Client.connect(addr)
        try:
            await client.put("k", "v")
            out["stalled"] = None
        except Status as e:
            out["stalled"] = (type(e).__name__, e.code.name)
        task.abort()
        return out

    return real.Runtime().block_on(main())


def kafka_roundtrip(ms) -> dict:
    real = sub(ms, "real")
    kafka = sub(ms, "real.kafka")
    NewTopic = sub(ms, "kafka").NewTopic

    async def main():
        broker = kafka.SimBroker()
        task, addr = await _started(real, broker)
        out = {"wire": type(broker.wire_server).__name__}
        config = kafka.ClientConfig().set("bootstrap.servers", addr)
        admin = await config.create(kafka.AdminClient)
        out["create"] = await admin.create_topics([NewTopic("t", 2)])
        producer = await config.create(kafka.FutureProducer)
        out["sent"] = [await producer.send(
            kafka.FutureRecord.to("t").with_partition(i % 2).with_key(f"k{i}")
            .with_payload(f"v{i}")) for i in range(6)]
        consumer = await config.create(kafka.BaseConsumer)
        await consumer.subscribe(["t"])
        got = []
        for _ in range(6):
            msg = await consumer.poll(timeout_s=1.0)
            got.append((msg.partition, msg.offset, msg.key, msg.payload))
        out["got"] = sorted(got)
        out["watermarks"] = [await consumer.fetch_watermarks("t", p) for p in (0, 1)]
        out["empty_poll"] = await consumer.poll(timeout_s=0.05)
        try:
            await consumer.fetch_watermarks("missing-topic", 0)
            out["missing"] = None
        except kafka.KafkaError as e:
            out["missing"] = type(e).__name__
        task.abort()
        return out

    return real.Runtime().block_on(main())


def s3_roundtrip(ms) -> dict:
    real = sub(ms, "real")
    s3 = sub(ms, "real.s3")

    async def main():
        task, addr = await _started(real, s3.SimServer())
        client = s3.Client.from_addr(addr)
        out = {}
        await client.create_bucket().bucket("b").send()
        for k, body in (("k", b"hello"), ("a/x", b"1"), ("a/y", b"22")):
            await client.put_object().bucket("b").key(k).body(body).send()
        got = await client.get_object().bucket("b").key("k").send()
        out["get"] = (await got.body.collect()).into_bytes()
        listed = await client.list_objects_v2().bucket("b").send()
        out["list"] = [o.key() for o in listed.contents()]
        listed = await client.list_objects_v2().bucket("b").prefix("a/").send()
        out["list_prefix"] = [o.key() for o in listed.contents()]
        try:
            await client.get_object().bucket("b").key("nope").send()
            out["missing"] = None
        except s3.S3Error as e:
            out["missing"] = (type(e).__name__, e.code)
        task.abort()
        return out

    return real.Runtime().block_on(main())


async def _session(probe, wire, client) -> dict:
    """ApiVersions, Metadata, CreateTopics, Produce, Fetch, ListOffsets
    and a two-member consumer-group session with a rebalance."""
    out = {"api_versions": (await client.api_versions(ver=0)),
           "api_versions_v3": (await client.api_versions(ver=3)),
           "create": await client.create_topics([("wt", 2)]),
           "metadata": await client.metadata()}
    out["produced"] = [await client.produce(
        "wt", i % 2, [(1_000 + i, f"k{i}".encode(), f"v{i}".encode())]) for i in range(8)]
    out["fetched"] = [await client.fetch("wt", p, 0) for p in (0, 1)]
    out["offsets"] = [(await client.list_offsets("wt", 0, ts))[2] for ts in (-1, -2)]
    m0, g0, a0 = await client.group_session("cg", ["wt"])
    hb = [await client.heartbeat("cg", g0, m0)]
    m1, g1, a1 = await client.group_session("cg", ["wt"])
    hb.append(await client.heartbeat("cg", g0, m0))
    m0b, g0b, a0b = await client.group_session("cg", ["wt"], member_id=m0)
    out["group"] = [(m0, g0, a0), (m1, g1, a1), (m0b, g0b, a0b)]
    out["commit"] = await client.offset_commit("cg", g0b, m0, [a0b[0] + (3,)])
    out["stale"] = await client.offset_commit("cg", g0, m0, [a0b[0] + (1,)])
    out["offset_fetch"] = await client.offset_fetch("cg", [a0b[0], a1[0]])
    hb.append(await client.leave_group("cg", m1))
    hb.append(await client.heartbeat("cg", g0b, m0))
    out["heartbeats"] = hb
    try:
        await client.produce("no-such-topic", 0, [(0, None, b"x")])
        out["unknown_topic"] = None
    except probe.ProbeError as e:
        out["unknown_topic"] = (type(e).__name__, e.code)
    out["rebalance_code"] = wire.ERR_REBALANCE_IN_PROGRESS
    return out


def _fetched_rows(out: dict) -> dict:
    """The produce timestamps the server stamps come from its wall clock
    when the batch says so; the fetched rows keep (offset, key, value)."""
    return {**out, "fetched": [(err, high, [(r[0], r[2], r[3]) for r in rows])
                               for err, high, rows in out["fetched"]]}


def probe_session(client_ms, server_ms=None) -> dict:
    """``client_ms``'s ``ProbeClient`` over TCP against ``server_ms``'s
    ``WireServer`` (the same package by default)."""
    server_ms = server_ms or client_ms
    real = sub(client_ms, "real")
    probe = sub(client_ms, "kafka.probe")
    wire = sub(server_ms, "kafka.wire")

    async def main():
        server = wire.WireServer()
        task, addr = await _started(sub(server_ms, "real"), server)
        client = probe.ProbeClient(await probe.RealTransport.connect(addr))
        out = await _session(probe, sub(client_ms, "kafka.wire"), client)
        client.close()
        task.abort()
        return _fetched_rows(out)

    return real.Runtime().block_on(main())


def loopback_transcript(client_ms, wire_ms=None) -> list:
    """Every (request, clock, response) frame of the session from
    ``client_ms``'s ``ProbeClient`` into ``wire_ms``'s ``KafkaWire`` on a
    fixed clock."""
    import asyncio

    wire_ms = wire_ms or client_ms
    probe = sub(client_ms, "kafka.probe")
    k = sub(wire_ms, "kafka.wire").KafkaWire(clock_ms=lambda: 4_200)
    k.recorder = transcript = []

    async def main():
        return await _session(probe, sub(client_ms, "kafka.wire"),
                              probe.ProbeClient(probe.LoopbackTransport(k)))

    out = asyncio.run(main())
    return [out, transcript]


SMOKE = {
    "greeter_real": greeter_real,
    "etcd_roundtrip": etcd_roundtrip,
    "kafka_roundtrip": kafka_roundtrip,
    "s3_roundtrip": s3_roundtrip,
    "probe_session": probe_session,
}
