"""The shim programs of the port's parity tests: the reference's gRPC,
etcd, Kafka, S3 and tokio tests (``tests/test_grpc.py``,
``test_etcd.py``, ``test_kafka.py``, ``test_s3.py``, ``test_aux.py``),
each written once as ``async def program(ms)`` over a package module
(``madsim_tpu`` or ``madsim_tpu_torch``), run under ``ms.Runtime(seed)``.

Each program keeps the reference test's assertions and returns what it
observed as plain data (gRPC ``Status`` values as ``(code, message)``,
etcd, Kafka and S3 results as tuples, lists and dicts), so two packages'
runs can be held equal with ``==``. ``record`` runs one with the
determinism log on and returns the log, the draw count, the final
virtual nanoseconds and the outputs.

This module imports neither package: ``chip_smoke.py`` phase 18 (c)
runs ``SMOKE`` over the port alone, and ``test_torch_shims_golden.py``
writes their digests from the reference into
``madsim_tpu_torch/data/host_shims.json``.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import io
import json


def sub(ms, name: str):
    return importlib.import_module(f"{ms.__name__}.{name}")


def example(ms, name: str):
    """The package's copy of an example: ``madsim_tpu_torch.examples.<name>``
    for the port, the repository's ``examples/<name>.py`` for the
    reference."""
    if ms.__name__ == "madsim_tpu":
        return importlib.import_module(f"examples.{name}")
    return importlib.import_module(f"{ms.__name__}.examples.{name}")


def record(ms, program, seed: int, config=None) -> dict:
    """One run of ``program(ms)`` under ``ms.Runtime(seed)`` (with the
    ``Config`` of the dict ``config``) and the determinism log on."""
    cfg = None if config is None else sub(ms, "config").Config.from_dict(config)
    rt = ms.Runtime(seed=seed, config=cfg)
    rt.rng.enable_log()
    out = rt.block_on(program(ms))
    return {"out": out, "now_ns": rt.time.now_ns, "draws": rt.rng._draw_count,
            "log": rt.rng.take_log()}


async def _status(coro, *types) -> tuple:
    """``(code, message)`` of the gRPC ``Status`` (or another of ``types``)
    the awaited call raised; fails when it returned."""
    try:
        await coro
    except types as e:
        code = getattr(e, "code", None)
        return (type(e).__name__, int(code) if code is not None else None,
                getattr(e, "message", str(e)))
    raise AssertionError("the call did not raise")


# ---------------------------------------------------------------------------
# gRPC (tests/test_grpc.py; the greeter of examples/greeter.py)

G_SERVER = "10.0.0.1"
G_ADDR = f"{G_SERVER}:50051"


def _cluster(ms, n_clients=1):
    """1 server + n client nodes with distinct IPs (ref test.rs:22-40)."""
    h = ms.current_handle()
    g = example(ms, "greeter")
    server = h.create_node().name("server").ip(G_SERVER).init(lambda: g.serve(G_ADDR)).build()
    clients = [h.create_node().name(f"client-{i}").ip(f"10.0.0.{i + 2}").build()
               for i in range(n_clients)]
    return server, clients


async def _connect(ms):
    grpc, g = sub(ms, "grpc"), example(ms, "greeter")
    channel = await grpc.Endpoint.from_static(f"http://{G_ADDR}").connect()
    return grpc.ServiceClient(g.Greeter, channel)


async def grpc_all_streaming_modes(ms):
    """The greeter's four call kinds (and the unary error path)."""
    grpc, g = sub(ms, "grpc"), example(ms, "greeter")
    Req = g.HelloRequest
    _server, (client,) = _cluster(ms)
    await ms.sleep(0.1)

    async def run():
        c = await _connect(ms)
        out = [(await c.say_hello(Req(name="world"))).into_inner().message]
        err = await _status(c.say_hello(Req(name="error")), grpc.Status)
        assert err[1] == grpc.Code.INVALID_ARGUMENT
        out.append(err)
        stream = await c.lots_of_replies(Req(name="s"))
        msgs = [m.message async for m in stream]
        assert msgs == ["0: Hello s!", "1: Hello s!", "2: Hello s!"]
        out.append(msgs)
        r = await c.lots_of_greetings([Req(name="a"), Req(name="b")])
        assert r.into_inner().message == "Hello a, b!"
        out.append(r.into_inner().message)
        stream = await c.bidi_hello([Req(name=x) for x in "xy"])
        msgs = [m.message async for m in stream]
        assert msgs == ["Hello x!", "Hello y!"]
        out.append(msgs)
        assert out[0] == "Hello world!"
        return out

    return await client.spawn(run())


async def grpc_client_crash_loop(ms):
    """Kill/restart a calling client 10 times; the server keeps serving
    (ref test.rs:155-202)."""
    g = example(ms, "greeter")
    h = ms.current_handle()
    _cluster(ms, n_clients=0)

    def client_init():
        async def run():
            c = await _connect(ms)
            while True:
                await c.say_hello(g.HelloRequest(name="w"))
                await ms.sleep(0.05)

        return run()

    node = h.create_node().name("crashy").ip("10.0.0.9").init(client_init).build()
    await ms.sleep(0.2)
    for _ in range(10):
        await ms.sleep(ms.rand.uniform(0.05, 0.3))
        h.kill(node)
        await ms.sleep(ms.rand.uniform(0.01, 0.1))
        h.restart(node)
    probe = h.create_node().name("probe").ip("10.0.0.8").build()

    async def check():
        c = await _connect(ms)
        r = await c.say_hello(g.HelloRequest(name="alive"))
        assert r.into_inner().message == "Hello alive!"
        return r.into_inner().message

    return await probe.spawn(check())


async def grpc_server_crash_mid_stream(ms):
    """Kill the server mid-stream: the stream errors Unavailable; after the
    restart calls succeed (ref test.rs:234-278)."""
    grpc, g = sub(ms, "grpc"), example(ms, "greeter")
    h = ms.current_handle()
    server, (client,) = _cluster(ms)
    await ms.sleep(0.1)

    async def run():
        c = await _connect(ms)
        stream = await c.lots_of_replies(g.HelloRequest(name="s"))
        first = await stream.message()
        assert first.message == "0: Hello s!"
        h.kill(server)

        async def drain():
            while await stream.message() is not None:
                pass

        mid = await _status(drain(), grpc.Status)
        assert mid[1] == grpc.Code.UNAVAILABLE
        down = await _status(c.say_hello(g.HelloRequest(name="down")), grpc.Status, OSError)
        h.restart(server)
        await ms.sleep(0.2)
        r = await c.say_hello(g.HelloRequest(name="back"))
        assert r.into_inner().message == "Hello back!"
        return [first.message, mid, down, r.into_inner().message]

    return await client.spawn(run())


async def grpc_unimplemented_service(ms):
    """Unknown service/method -> UNIMPLEMENTED (ref test.rs:281-318)."""
    grpc, g = sub(ms, "grpc"), example(ms, "greeter")

    @grpc.service("other.Unknown")
    class Unknown:
        @grpc.unary
        async def nope(self, request):
            return None

    _server, (client,) = _cluster(ms)
    await ms.sleep(0.1)

    async def run():
        channel = await grpc.Endpoint.from_static(f"http://{G_ADDR}").connect()
        c = grpc.ServiceClient(Unknown, channel)
        err = await _status(c.nope(g.HelloRequest(name="x")), grpc.Status)
        assert err[1] == grpc.Code.UNIMPLEMENTED
        return err

    return await client.spawn(run())


async def grpc_interceptor(ms):
    """A client interceptor mutates metadata and rejects requests
    (ref test.rs:321-360)."""
    grpc, g = sub(ms, "grpc"), example(ms, "greeter")

    @grpc.service("helloworld.Echo")
    class Echo:
        @grpc.unary
        async def echo_meta(self, request):
            return g.HelloReply(message=request.metadata.get("x-token", ""))

    h = ms.current_handle()
    h.create_node().name("server").ip(G_SERVER).init(
        lambda: grpc.Server.builder().add_service(Echo()).serve(G_ADDR)).build()
    client = h.create_node().name("client").ip("10.0.0.2").build()
    await ms.sleep(0.1)

    async def run():
        channel = await grpc.Endpoint.from_static(f"http://{G_ADDR}").connect()

        def add_token(req):
            req.metadata["x-token"] = "secret"
            return req

        c = grpc.ServiceClient.with_interceptor(Echo, channel, add_token)
        r = await c.echo_meta(g.HelloRequest(name="x"))
        assert r.into_inner().message == "secret"

        def reject(req):
            raise grpc.Status.permission_denied("no token")

        c2 = grpc.ServiceClient.with_interceptor(Echo, channel, reject)
        err = await _status(c2.echo_meta(g.HelloRequest(name="x")), grpc.Status)
        assert err[1] == grpc.Code.PERMISSION_DENIED
        return [r.into_inner().message, err]

    return await client.spawn(run())


async def grpc_request_timeout(ms):
    """grpc-timeout: a slow handler trips the client deadline with
    CANCELLED "Timeout expired" (ref test.rs:363-408)."""
    grpc, g = sub(ms, "grpc"), example(ms, "greeter")
    _server, (client,) = _cluster(ms)
    await ms.sleep(0.1)

    async def run():
        c = await _connect(ms)
        req = grpc.Request(g.HelloRequest(name="slow", delay_s=10.0), timeout=1.0)
        err = await _status(c.say_hello(req), grpc.Status)
        assert err[1] == grpc.Code.CANCELLED and "Timeout expired" in err[2]
        channel = await grpc.Endpoint.from_static(f"http://{G_ADDR}").timeout(0.5).connect()
        c2 = grpc.ServiceClient(g.Greeter, channel)
        err2 = await _status(c2.say_hello(g.HelloRequest(name="slow", delay_s=10.0)),
                             grpc.Status)
        return [err, err2, ms.time.elapsed()]

    return await client.spawn(run())


def _who_am_i(ms):
    grpc, g = sub(ms, "grpc"), example(ms, "greeter")

    @grpc.service("helloworld.WhoAmI")
    class WhoAmI:
        """Identifies which balanced backend served a call."""

        def __init__(self, tag: str = "?"):
            self.tag = tag

        @grpc.unary
        async def who(self, request):
            return g.HelloReply(message=self.tag)

    return WhoAmI


def _tagged_cluster(ms, WhoAmI, ips):
    """One WhoAmI server per ip, tagged s0, s1, ... (balance tests)."""
    grpc, h = sub(ms, "grpc"), ms.current_handle()
    for i, ip in enumerate(ips):
        h.create_node().name(f"s{i}").ip(ip).init(
            lambda i=i, ip=ip: grpc.Server.builder()
            .add_service(WhoAmI(tag=f"s{i}")).serve(f"{ip}:50051")).build()


async def grpc_balance_list(ms):
    """balance_list spreads calls over endpoints at random
    (ref transport/channel.rs:294-307)."""
    grpc, g = sub(ms, "grpc"), example(ms, "greeter")
    WhoAmI = _who_am_i(ms)
    h = ms.current_handle()
    _tagged_cluster(ms, WhoAmI, ["10.0.1.1", "10.0.1.2", "10.0.1.3"])
    client = h.create_node().name("client").ip("10.0.0.2").build()
    await ms.sleep(0.1)

    async def run():
        channel = grpc.Channel.balance_list(
            [grpc.Endpoint.from_static(f"http://10.0.1.{j}:50051") for j in (1, 2, 3)])
        c = grpc.ServiceClient(WhoAmI, channel)
        seq = [(await c.who(g.HelloRequest(name="x"))).into_inner().message
               for _ in range(30)]
        assert set(seq) == {"s0", "s1", "s2"}
        return seq

    return await client.spawn(run())


async def grpc_determinism_workload(ms):
    """The gRPC-heavy workload of the reference's determinism test."""
    g = example(ms, "greeter")
    _server, (client,) = _cluster(ms)
    await ms.sleep(0.1)

    async def run():
        c = await _connect(ms)
        return [(await c.say_hello(g.HelloRequest(name="d"))).into_inner().message
                for _ in range(5)]

    return await client.spawn(run())


async def grpc_invalid_address(ms):
    """Connecting to an address nobody serves fails, not hangs
    (ref test.rs:141-152)."""
    grpc = sub(ms, "grpc")
    client = ms.current_handle().create_node().name("client").ip("10.0.0.2").build()

    async def run():
        ep = grpc.Endpoint.from_static(f"http://{G_ADDR}").connect_timeout(1.0)
        return [await _status(ep.connect(), grpc.Status), ms.time.elapsed()]

    return await client.spawn(run())


async def grpc_client_drops_response_stream(ms):
    """Dropping a server-streaming response mid-stream does not wedge the
    server (ref test.rs:205-232)."""
    g = example(ms, "greeter")
    _server, (client,) = _cluster(ms)
    await ms.sleep(1.0)

    async def run():
        c = await _connect(ms)
        stream = await c.lots_of_replies(g.HelloRequest(name="Tonic"))
        first = await stream.__anext__()
        assert first.message == "0: Hello Tonic!"
        stream.close()
        await ms.sleep(10.0)
        r = await c.say_hello(g.HelloRequest(name="Tonic"))
        assert r.into_inner().message == "Hello Tonic!"
        return [first.message, r.into_inner().message]

    return await client.spawn(run())


async def grpc_balance_channel_dynamic(ms):
    """balance_channel: endpoints inserted/removed at runtime steer later
    calls; an empty set is Unavailable (ref transport/channel.rs:335-359)."""
    grpc, g = sub(ms, "grpc"), example(ms, "greeter")
    WhoAmI = _who_am_i(ms)
    h = ms.current_handle()
    _tagged_cluster(ms, WhoAmI, ["10.0.1.1", "10.0.1.2"])
    client = h.create_node().name("client").ip("10.0.0.2").build()
    await ms.sleep(0.1)

    async def run():
        channel, tx = grpc.Channel.balance_channel()
        c = grpc.ServiceClient(WhoAmI, channel)
        empty = await _status(c.who(g.HelloRequest(name="x")), grpc.Status)
        assert empty[1] == grpc.Code.UNAVAILABLE
        await tx.send(grpc.Change.insert("a", grpc.Endpoint.from_static("http://10.0.1.1:50051")))
        await tx.send(grpc.Change.insert("b", grpc.Endpoint.from_static("http://10.0.1.2:50051")))
        seq = [(await c.who(g.HelloRequest(name="x"))).into_inner().message for _ in range(20)]
        assert set(seq) == {"s0", "s1"}
        await tx.send(grpc.Change.remove("a"))
        after = [(await c.who(g.HelloRequest(name="x"))).into_inner().message for _ in range(10)]
        assert after == ["s1"] * 10
        return [empty, seq, after]

    return await client.spawn(run())


# ---------------------------------------------------------------------------
# etcd (tests/test_etcd.py)

E_ADDR = "10.0.0.1:2379"


async def _with_etcd(ms, client_fn, timeout_rate=0.0):
    etcd = sub(ms, "etcd")
    h = ms.current_handle()
    h.create_node().name("etcd").ip("10.0.0.1").init(
        lambda: etcd.SimServer.builder().timeout_rate(timeout_rate).serve(E_ADDR)).build()
    node = h.create_node().name("client").ip("10.0.0.2").build()
    await ms.sleep(0.1)
    return await node.spawn(client_fn())


def _kvs(resp) -> list:
    return [(k.key, k.value, k.create_revision, k.mod_revision, k.version, k.lease)
            for k in resp.kvs()]


async def etcd_kv_put_get_delete_prefix(ms):
    etcd = sub(ms, "etcd")

    async def run():
        client = await etcd.Client.connect([E_ADDR])
        kv = client.kv_client()
        await kv.put("hello", "world", None)
        resp = await kv.get("hello", None)
        assert resp.kvs()[0].value_str() == "world" and resp.count() == 1
        out = [_kvs(resp)]
        r1 = (await kv.put("hello", "world2", None)).header().revision()
        resp = await kv.get("hello", None)
        assert resp.kvs()[0].mod_revision == r1 and resp.kvs()[0].version == 2
        out += [r1, _kvs(resp)]
        await kv.put("key/a", "1", None)
        await kv.put("key/b", "2", None)
        resp = await kv.get("key/", etcd.GetOptions().with_prefix())
        assert [k.key_str() for k in resp.kvs()] == ["key/a", "key/b"]
        out.append(_kvs(resp))
        dresp = await kv.delete("key/", etcd.DeleteOptions().with_prefix())
        assert dresp.deleted() == 2
        assert (await kv.get("key/", etcd.GetOptions().with_prefix())).count() == 0
        return out

    return await _with_etcd(ms, run)


async def etcd_txn_compare_and_ops(ms):
    etcd = sub(ms, "etcd")
    Txn, TxnOp, Compare, CompareOp = etcd.Txn, etcd.TxnOp, etcd.Compare, etcd.CompareOp

    async def run():
        kv = (await etcd.Client.connect([E_ADDR])).kv_client()
        await kv.put("k", "v1", None)
        resp = await kv.txn(
            Txn().when([Compare.value("k", CompareOp.EQUAL, "v1")])
            .and_then([TxnOp.put("k", "v2", None), TxnOp.get("k", None)])
            .or_else([TxnOp.put("k", "wrong", None)]))
        assert resp.succeeded()
        resp2 = await kv.txn(
            Txn().when([Compare.value("k", CompareOp.EQUAL, "v1")])
            .and_then([TxnOp.put("k", "nope", None)])
            .or_else([TxnOp.txn(Txn().and_then([TxnOp.put("k", "v3", None)]))]))
        assert not resp2.succeeded()
        final = await kv.get("k", None)
        assert final.kvs()[0].value_str() == "v3"
        return [resp.succeeded(), resp2.succeeded(), _kvs(final)]

    return await _with_etcd(ms, run)


async def etcd_lease_expiry_on_sim_time(ms):
    """Lease TTL runs on virtual seconds (ref tests/test.rs:96-120)."""
    etcd, grpc = sub(ms, "etcd"), sub(ms, "grpc")

    async def run():
        client = await etcd.Client.connect([E_ADDR])
        lease, kv = client.lease_client(), client.kv_client()
        lid = (await lease.grant(60)).id()
        await kv.put("leased", "v", etcd.PutOptions().with_lease(lid))
        assert (await kv.get("leased", None)).count() == 1
        await ms.sleep(30)
        await lease.keep_alive(lid)
        await ms.sleep(40)
        assert (await kv.get("leased", None)).count() == 1
        ttl = await lease.time_to_live(lid)
        assert ttl.granted_ttl() == 60
        await ms.sleep(61)
        assert (await kv.get("leased", None)).count() == 0
        err = await _status(lease.time_to_live(lid), grpc.Status)
        assert err[1] == grpc.Code.NOT_FOUND
        return [lid, ttl.granted_ttl(), err, ms.time.elapsed()]

    return await _with_etcd(ms, run)


async def etcd_lease_revoke_deletes_keys(ms):
    etcd = sub(ms, "etcd")

    async def run():
        client = await etcd.Client.connect([E_ADDR])
        lease, kv = client.lease_client(), client.kv_client()
        lid = (await lease.grant(600)).id()
        await kv.put("a", "1", etcd.PutOptions().with_lease(lid))
        await kv.put("b", "2", etcd.PutOptions().with_lease(lid))
        leases = await lease.leases()
        assert leases == [lid]
        await lease.revoke(lid)
        counts = [(await kv.get(k, None)).count() for k in ("a", "b")]
        assert counts == [0, 0]
        return [lid, leases, counts]

    return await _with_etcd(ms, run)


async def etcd_election_campaign_observe_resign(ms):
    """Two campaigners: the first wins; on resign the second takes over."""
    etcd = sub(ms, "etcd")

    async def run():
        client = await etcd.Client.connect([E_ADDR])
        lease, el = client.lease_client(), client.election_client()
        l1 = (await lease.grant(600)).id()
        l2 = (await lease.grant(600)).id()
        c1 = await el.campaign("mayor", "alice", l1)
        first_leader = (await el.leader("mayor")).kv().value_str()
        assert first_leader == "alice"

        async def second():
            return await el.campaign("mayor", "bob", l2)

        t2 = ms.spawn(second())
        await ms.sleep(1)
        assert not t2.done()
        await el.proclaim("alice-2", c1.leader())
        proclaimed = (await el.leader("mayor")).kv().value_str()
        assert proclaimed == "alice-2"
        obs = await el.observe("mayor")
        first = (await obs.next()).value.decode()
        assert first in ("alice-2", "bob")
        await el.resign(c1.leader())
        c2 = await t2
        assert c2.leader().key().startswith(b"mayor/")
        last = (await el.leader("mayor")).kv().value_str()
        assert last == "bob"
        obs.cancel()
        return [first_leader, proclaimed, first, c2.leader().key(), last]

    return await _with_etcd(ms, run)


async def etcd_request_too_large(ms):
    """1.5 MiB request cap (service.rs:36)."""
    etcd, grpc = sub(ms, "etcd"), sub(ms, "grpc")

    async def run():
        kv = (await etcd.Client.connect([E_ADDR])).kv_client()
        err = await _status(kv.put("big", b"x" * (2 * 1024 * 1024), None), grpc.Status)
        assert err[1] == grpc.Code.INVALID_ARGUMENT and "too large" in err[2]
        return err

    return await _with_etcd(ms, run)


async def etcd_timeout_rate_injection(ms):
    """timeout_rate=1.0: every request hangs 5-15 virtual seconds, then
    fails Unavailable (server.rs:20-25, service.rs:165-176)."""
    etcd, grpc = sub(ms, "etcd"), sub(ms, "grpc")

    async def run():
        client = await etcd.Client.connect([E_ADDR])
        t0 = ms.time.elapsed()
        err = await _status(client.kv_client().put("k", "v", None), grpc.Status)
        waited = ms.time.elapsed() - t0
        assert err[1] == grpc.Code.UNAVAILABLE and 5.0 <= waited <= 16.0
        return [err, waited]

    return await _with_etcd(ms, run, timeout_rate=1.0)


async def etcd_dump_load_snapshot_restore(ms):
    """State dump/load round-trip (service.rs:160-163, sim.rs:70-77)."""
    etcd = sub(ms, "etcd")
    h = ms.current_handle()
    h.create_node().name("etcd1").ip("10.0.0.1").init(
        lambda: etcd.SimServer.builder().serve(E_ADDR)).build()
    node = h.create_node().name("client").ip("10.0.0.2").build()
    await ms.sleep(0.1)

    async def run():
        client = await etcd.Client.connect([E_ADDR])
        kv = client.kv_client()
        lid = (await client.lease_client().grant(300)).id()
        await kv.put("persist", "me", etcd.PutOptions().with_lease(lid))
        await kv.put("also", "this", None)
        dump = await client.dump()
        h.create_node().name("etcd2").ip("10.0.0.3").init(
            lambda: etcd.SimServer.builder().load(dump).serve("10.0.0.3:2379")).build()
        await ms.sleep(0.1)
        c2 = await etcd.Client.connect(["10.0.0.3:2379"])
        resp = await c2.kv_client().get("persist", None)
        assert resp.kvs()[0].value_str() == "me" and resp.kvs()[0].lease == lid
        also = (await c2.kv_client().get("also", None)).count()
        assert also == 1
        return [dump, _kvs(resp), also]

    return await node.spawn(run())


async def etcd_watch_prefix_stream(ms):
    etcd = sub(ms, "etcd")

    async def run():
        client = await etcd.Client.connect([E_ADDR])
        stream = await client.watch_client().watch("w/", prefix=True)
        kv = client.kv_client()

        async def writer():
            await kv.put("w/1", "a", None)
            await kv.put("other", "x", None)
            await kv.put("w/2", "b", None)
            await kv.delete("w/1", None)

        ms.spawn(writer())
        events = [await stream.next() for _ in range(3)]
        assert events[0].type == etcd.EventType.PUT and events[0].kv.key == b"w/1"
        assert events[1].kv.key == b"w/2"
        assert events[2].type == etcd.EventType.DELETE and events[2].kv.key == b"w/1"
        stream.cancel()
        return [(e.type.name, e.kv.key, e.kv.value, e.kv.mod_revision) for e in events]

    return await _with_etcd(ms, run)


async def etcd_determinism_workload(ms):
    etcd = sub(ms, "etcd")

    async def run():
        client = await etcd.Client.connect([E_ADDR])
        for i in range(5):
            await client.kv_client().put(f"k{i}", f"v{i}", None)
        resp = await client.kv_client().get("k", etcd.GetOptions().with_prefix())
        assert resp.count() == 5
        return _kvs(resp)

    return await _with_etcd(ms, run)


async def etcd_maintenance_status(ms):
    """maintenance_client().status() reports server state
    (ref tests/test.rs:240-263)."""
    etcd = sub(ms, "etcd")

    async def run():
        client = await etcd.Client.connect([E_ADDR])
        await client.kv_client().put("sk", "sv", None)
        status = await client.maintenance_client().status()
        assert status is not None
        return repr(status)

    return await _with_etcd(ms, run)


async def etcd_smoke(ms):
    """Phase 18 (c)'s etcd program: kv, a txn, a lease, an election and a
    prefix watch against one server."""
    etcd = sub(ms, "etcd")
    Txn, TxnOp, Compare, CompareOp = etcd.Txn, etcd.TxnOp, etcd.Compare, etcd.CompareOp

    async def run():
        client = await etcd.Client.connect([E_ADDR])
        kv, lease, el = client.kv_client(), client.lease_client(), client.election_client()
        stream = await client.watch_client().watch("w/", prefix=True)
        lid = (await lease.grant(5)).id()
        for i in range(4):
            await kv.put(f"w/{i}", f"v{i}", etcd.PutOptions().with_lease(lid) if i % 2 else None)
            await ms.sleep(ms.rand.uniform(0.0, 0.2))
        txn = await kv.txn(
            Txn().when([Compare.value("w/0", CompareOp.EQUAL, "v0")])
            .and_then([TxnOp.put("w/0", "t", None)]).or_else([TxnOp.get("w/0", None)]))
        events = [await stream.next() for _ in range(5)]
        c1 = await el.campaign("mayor", "alice", lid)
        leader = (await el.leader("mayor")).kv().value_str()
        await el.resign(c1.leader())
        await ms.sleep(6)
        left = await kv.get("w/", etcd.GetOptions().with_prefix())
        stream.cancel()
        return [txn.succeeded(), leader,
                [(e.type.name, e.kv.key, e.kv.value, e.kv.mod_revision) for e in events],
                _kvs(left)]

    return await _with_etcd(ms, run)


# ---------------------------------------------------------------------------
# Kafka (tests/test_kafka.py)

BROKER = "10.0.0.1:9092"


async def _with_broker(ms, client_fn):
    kafka = sub(ms, "kafka")
    h = ms.current_handle()
    h.create_node().name("broker").ip("10.0.0.1").init(
        lambda: kafka.SimBroker().serve(BROKER)).build()
    node = h.create_node().name("client").ip("10.0.0.2").build()
    await ms.sleep(0.1)
    return await node.spawn(client_fn())


def _cfg(ms):
    return sub(ms, "kafka").ClientConfig().set("bootstrap.servers", BROKER)


def _gcfg(ms, group: str, auto: bool = True):
    c = _cfg(ms).set("group.id", group)
    if not auto:
        c.set("enable.auto.commit", "false")
    return c


def _msg(m) -> tuple:
    return None if m is None else (m.topic, m.partition, m.offset, m.key, m.payload, m.timestamp_ms)


async def kafka_produce_consume_round_robin(ms):
    k = sub(ms, "kafka")

    async def run():
        admin = await _cfg(ms).create(k.AdminClient)
        errs = await admin.create_topics([k.NewTopic.new("t", 3)])
        assert errs == [None]
        dup = await admin.create_topics([k.NewTopic.new("t", 3)])
        assert dup[0] is not None
        producer = await _cfg(ms).create(k.FutureProducer)
        sent = [await producer.send(k.BaseRecord.to("t").with_payload(f"m{i}"))
                for i in range(6)]
        assert {p for p, _ in sent} == {0, 1, 2}
        consumer = await _cfg(ms).create(k.BaseConsumer)
        await consumer.subscribe(["t"])
        got = []
        for _ in range(6):
            msg = await consumer.poll(1.0)
            assert msg is not None
            got.append(_msg(msg))
        assert {m[4].decode() for m in got} == {f"m{i}" for i in range(6)}
        assert await consumer.poll(0.1) is None
        return [errs, dup, sent, got]

    return await _with_broker(ms, run)


async def kafka_keyed_produce_is_sticky(ms):
    k = sub(ms, "kafka")

    async def run():
        admin = await _cfg(ms).create(k.AdminClient)
        await admin.create_topics([k.NewTopic.new("t", 4)])
        producer = await _cfg(ms).create(k.FutureProducer)
        sent = [await producer.send(k.BaseRecord.to("t").with_key("k1").with_payload(str(i)))
                for i in range(5)]
        assert len({p for p, _ in sent}) == 1
        return sent

    return await _with_broker(ms, run)


async def kafka_base_producer_buffers_until_flush(ms):
    k = sub(ms, "kafka")

    async def run():
        admin = await _cfg(ms).create(k.AdminClient)
        await admin.create_topics([k.NewTopic.new("t", 1)])
        producer = await _cfg(ms).create(k.BaseProducer)
        consumer = await _cfg(ms).create(k.BaseConsumer)
        await consumer.subscribe(["t"])
        producer.send(k.BaseRecord.to("t").with_payload("a"))
        producer.send(k.BaseRecord.to("t").with_payload("b"))
        assert producer.in_flight_count() == 2
        assert await consumer.poll(0.1) is None
        await producer.flush()
        got = [_msg(await consumer.poll(1.0)) for _ in range(2)]
        assert [m[4] for m in got] == [b"a", b"b"]
        return got

    return await _with_broker(ms, run)


async def kafka_watermarks_seek_offsets_for_times(ms):
    k = sub(ms, "kafka")

    async def run():
        admin = await _cfg(ms).create(k.AdminClient)
        await admin.create_topics([k.NewTopic.new("t", 1)])
        producer = await _cfg(ms).create(k.FutureProducer)
        t_mid = None
        for i in range(5):
            if i == 3:
                await ms.sleep(5)
                t_mid = int(ms.time.now() * 1000)
            await producer.send(k.BaseRecord.to("t").with_payload(f"m{i}"))
        consumer = await _cfg(ms).create(k.BaseConsumer)
        marks = tuple(await consumer.fetch_watermarks("t", 0))
        assert marks == (0, 5)
        tpl = k.TopicPartitionList().add_partition_offset("t", 0, t_mid)
        [(_, _, off)] = await consumer.offsets_for_times(tpl)
        assert off == 3
        await consumer.assign(k.TopicPartitionList().add_partition("t", 0))
        consumer.seek("t", 0, off)
        m = _msg(await consumer.poll(1.0))
        assert m[4] == b"m3"
        return [marks, t_mid, off, m]

    return await _with_broker(ms, run)


async def kafka_fetch_byte_budget(ms):
    k = sub(ms, "kafka")

    async def run():
        admin = await _cfg(ms).create(k.AdminClient)
        await admin.create_topics([k.NewTopic.new("t", 1)])
        producer = await _cfg(ms).create(k.FutureProducer)
        for _ in range(10):
            await producer.send(k.BaseRecord.to("t").with_payload(b"x" * 100))
        consumer = await _cfg(ms).set("max.partition.fetch.bytes", 250).create(k.BaseConsumer)
        await consumer.subscribe(["t"])
        got = []
        for _ in range(10):
            m = await consumer.poll(1.0)
            assert m is not None
            got.append((m.offset, ms.time.now_instant().ns))
        assert await consumer.poll(0.05) is None
        return got

    return await _with_broker(ms, run)


async def kafka_stream_consumer_and_linger(ms):
    k = sub(ms, "kafka")

    async def run():
        admin = await _cfg(ms).create(k.AdminClient)
        await admin.create_topics([k.NewTopic.new("t", 2)])
        consumer = await _cfg(ms).create(k.StreamConsumer)
        await consumer.subscribe(["t"])

        async def produce_later():
            producer = await _cfg(ms).set("linger.ms", 50).create(k.FutureProducer)
            await ms.sleep(1.0)
            await producer.send(k.BaseRecord.to("t").with_payload("late"))

        ms.spawn(produce_later())
        t0 = ms.time.elapsed()
        msg = await consumer.recv()
        waited = ms.time.elapsed() - t0
        assert msg.payload == b"late" and waited >= 1.0
        return [_msg(msg), waited]

    return await _with_broker(ms, run)


async def kafka_broker_crash_restart(ms):
    k = sub(ms, "kafka")
    h = ms.current_handle()
    broker = h.create_node().name("broker").ip("10.0.0.1").init(
        lambda: k.SimBroker().serve(BROKER)).build()
    node = h.create_node().name("client").ip("10.0.0.2").build()
    await ms.sleep(0.1)

    async def run():
        admin = await _cfg(ms).create(k.AdminClient)
        await admin.create_topics([k.NewTopic.new("t", 1)])
        producer = await _cfg(ms).create(k.FutureProducer)
        pre = await producer.send(k.BaseRecord.to("t").with_payload("pre"))
        h.kill(broker)
        down = await _status(producer.send(k.BaseRecord.to("t").with_payload("down")),
                             k.KafkaError)
        h.restart(broker)
        await ms.sleep(0.2)
        gone = await _status(producer.send(k.BaseRecord.to("t").with_payload("post")),
                             k.KafkaError)
        assert "unknown topic" in gone[2]
        await admin.create_topics([k.NewTopic.new("t", 1)])
        post = await producer.send(k.BaseRecord.to("t").with_payload("post"))
        assert tuple(post) == (0, 0)
        return [pre, down, gone, post]

    return await node.spawn(run())


async def kafka_two_producers_two_consumers(ms):
    """The reference's flagship topology (tests/test.rs:21-100): admin + 2
    producers + 2 consumers on separate nodes over sim DNS."""
    k = sub(ms, "kafka")
    NetSim, simulator = sub(ms, "net").NetSim, sub(ms, "plugin").simulator
    h = ms.current_handle()
    h.create_node().name("broker").ip("10.0.0.1").init(
        lambda: k.SimBroker().serve(BROKER)).build()
    await ms.sleep(0.1)
    simulator(NetSim).add_dns_record("kafka-broker", "10.0.0.1")
    dns_cfg = k.ClientConfig().set("bootstrap.servers", "kafka-broker:9092")
    admin_node = h.create_node().name("admin").ip("10.0.0.2").build()

    async def setup():
        admin = await dns_cfg.create(k.AdminClient)
        errs = await admin.create_topics([k.NewTopic.new("events", 4)])
        assert errs == [None]

    await admin_node.spawn(setup())
    results = []

    def producer_init(tag):
        def make():
            async def run():
                p = await dns_cfg.create(k.FutureProducer)
                for i in range(10):
                    await p.send(k.BaseRecord.to("events").with_payload(f"{tag}-{i}"))
                    await ms.sleep(0.01)

            return run()

        return make

    h.create_node().name("p1").ip("10.0.0.3").init(producer_init("p1")).build()
    h.create_node().name("p2").ip("10.0.0.4").init(producer_init("p2")).build()

    async def consume(partitions):
        c = await dns_cfg.create(k.BaseConsumer)
        tpl = k.TopicPartitionList()
        for p in partitions:
            tpl.add_partition("events", p)
        await c.assign(tpl)
        while True:
            msg = await c.poll(2.0)
            if msg is None:
                return
            results.append(_msg(msg))

    t1 = h.create_node().name("c1").ip("10.0.0.5").build().spawn(consume([0, 1]))
    t2 = h.create_node().name("c2").ip("10.0.0.6").build().spawn(consume([2, 3]))
    await t1
    await t2
    assert sorted(m[4].decode() for m in results) == sorted(
        f"p{j}-{i}" for j in (1, 2) for i in range(10))
    return results


async def kafka_determinism_workload(ms):
    k = sub(ms, "kafka")

    async def run():
        admin = await _cfg(ms).create(k.AdminClient)
        await admin.create_topics([k.NewTopic.new("t", 2)])
        producer = await _cfg(ms).create(k.FutureProducer)
        for i in range(8):
            await producer.send(k.BaseRecord.to("t").with_payload(f"m{i}"))
        consumer = await _cfg(ms).create(k.BaseConsumer)
        await consumer.subscribe(["t"])
        got = []
        while (m := await consumer.poll(0.2)) is not None:
            got.append(_msg(m))
        assert len(got) == 8
        return got

    return await _with_broker(ms, run)


async def kafka_group_splits_partitions(ms):
    """Two members of one group split 4 partitions 2/2 and together consume
    every message exactly once."""
    k = sub(ms, "kafka")

    async def run():
        admin = await _cfg(ms).create(k.AdminClient)
        await admin.create_topics([k.NewTopic.new("g1", 4)])
        producer = await _cfg(ms).create(k.FutureProducer)
        for i in range(12):
            await producer.send(k.BaseRecord.to("g1").with_payload(f"m{i}"))
        a = await _gcfg(ms, "grp").create(k.BaseConsumer)
        b = await _gcfg(ms, "grp").create(k.BaseConsumer)
        await a.subscribe(["g1"])
        await b.subscribe(["g1"])
        got_a, got_b = [], []
        for _ in range(24):
            m = await a.poll(timeout_s=0.1)
            if m:
                got_a.append(m.payload.decode())
            m = await b.poll(timeout_s=0.1)
            if m:
                got_b.append(m.payload.decode())
        pa = sorted(x.partition for x in a._assignments)
        pb = sorted(x.partition for x in b._assignments)
        assert len(pa) == 2 and len(pb) == 2 and set(pa).isdisjoint(pb)
        assert sorted(got_a + got_b) == sorted(f"m{i}" for i in range(12))
        return [pa, pb, got_a, got_b]

    return await _with_broker(ms, run)


async def kafka_group_rebalance_on_join_and_leave(ms):
    k = sub(ms, "kafka")

    async def run():
        admin = await _cfg(ms).create(k.AdminClient)
        await admin.create_topics([k.NewTopic.new("g2", 4)])
        a = await _gcfg(ms, "grp2").create(k.BaseConsumer)
        await a.subscribe(["g2"])
        sizes = [len(a._assignments)]
        b = await _gcfg(ms, "grp2").create(k.BaseConsumer)
        await b.subscribe(["g2"])
        await a.poll(timeout_s=0.05)
        sizes += [len(a._assignments), len(b._assignments)]
        await b.unsubscribe()
        await a.poll(timeout_s=0.05)
        sizes.append(len(a._assignments))
        assert sizes == [4, 2, 2, 4]
        return sizes

    return await _with_broker(ms, run)


async def kafka_group_commit_and_resume(ms):
    k = sub(ms, "kafka")

    async def run():
        admin = await _cfg(ms).create(k.AdminClient)
        await admin.create_topics([k.NewTopic.new("g3", 1)])
        producer = await _cfg(ms).create(k.FutureProducer)
        for i in range(6):
            await producer.send(k.BaseRecord.to("g3").with_payload(f"m{i}"))
        first = await _gcfg(ms, "grp3", auto=False).create(k.BaseConsumer)
        await first.subscribe(["g3"])
        for _ in range(3):
            assert await first.poll(timeout_s=0.5) is not None
        await first.commit()
        await first.unsubscribe()
        second = await _gcfg(ms, "grp3", auto=False).create(k.BaseConsumer)
        await second.subscribe(["g3"])
        m2 = _msg(await second.poll(timeout_s=0.5))
        assert m2 is not None and m2[4] == b"m3"
        fresh = await _gcfg(ms, "other", auto=False).create(k.BaseConsumer)
        await fresh.subscribe(["g3"])
        m3 = _msg(await fresh.poll(timeout_s=0.5))
        assert m3 is not None and m3[4] == b"m0"
        return [m2, m3]

    return await _with_broker(ms, run)


async def kafka_group_auto_commit_on_unsubscribe(ms):
    k = sub(ms, "kafka")

    async def run():
        admin = await _cfg(ms).create(k.AdminClient)
        await admin.create_topics([k.NewTopic.new("g4", 1)])
        producer = await _cfg(ms).create(k.FutureProducer)
        for i in range(4):
            await producer.send(k.BaseRecord.to("g4").with_payload(f"m{i}"))
        first = await _gcfg(ms, "grp4").create(k.BaseConsumer)
        await first.subscribe(["g4"])
        for _ in range(2):
            assert await first.poll(timeout_s=0.5) is not None
        await first.unsubscribe()
        second = await _gcfg(ms, "grp4").create(k.BaseConsumer)
        await second.subscribe(["g4"])
        m = _msg(await second.poll(timeout_s=0.5))
        assert m is not None and m[4] == b"m2"
        return m

    return await _with_broker(ms, run)


async def kafka_group_commits_before_revoke(ms):
    """Commit-on-revoke: a rebalance where the old owner heartbeats before
    the new owner fetches re-delivers nothing."""
    k = sub(ms, "kafka")

    async def run():
        admin = await _cfg(ms).create(k.AdminClient)
        await admin.create_topics([k.NewTopic.new("g6", 1)])
        producer = await _cfg(ms).create(k.FutureProducer)
        for i in range(6):
            await producer.send(k.BaseRecord.to("g6").with_payload(f"m{i}"))
        a = await _gcfg(ms, "grp6").create(k.BaseConsumer)
        await a.subscribe(["g6"])
        seen = [(await a.poll(timeout_s=0.5)).payload.decode() for _ in range(3)]
        assert seen == ["m0", "m1", "m2"]
        b = await _gcfg(ms, "grp6").create(k.BaseConsumer)
        await b.subscribe(["g6"])
        got = []
        for _ in range(10):
            for c in (a, b):
                m = await c.poll(timeout_s=0.05)
                if m:
                    got.append(m.payload.decode())
        assert got == ["m3", "m4", "m5"]
        return [seen, got]

    return await _with_broker(ms, run)


async def kafka_group_commit_generation_fencing(ms):
    """A zombie member cannot roll the group's committed offsets backward
    (ILLEGAL_GENERATION); the new owner's commit survives."""
    k = sub(ms, "kafka")

    async def run():
        admin = await _cfg(ms).create(k.AdminClient)
        await admin.create_topics([k.NewTopic.new("g8", 1)])
        producer = await _cfg(ms).create(k.FutureProducer)
        for i in range(6):
            await producer.send(k.BaseRecord.to("g8").with_payload(f"m{i}"))
        zombie = await _gcfg(ms, "grp8", auto=False).create(k.BaseConsumer)
        await zombie.subscribe(["g8"])
        for _ in range(3):
            assert await zombie.poll(timeout_s=0.5) is not None
        await zombie.commit()
        other = await _gcfg(ms, "grp8", auto=False).create(k.BaseConsumer)
        await other.subscribe(["g8"])
        fenced = await _status(zombie.commit(), k.KafkaError)
        assert "ILLEGAL_GENERATION" in fenced[2]
        tpl = k.TopicPartitionList().add_partition("g8", 0)
        before = [tuple(c) for c in await other.committed(tpl)]
        assert before[0][2] == 3
        while await zombie.poll(timeout_s=0.3) is not None:
            pass
        await zombie.commit()
        after = [tuple(c) for c in await other.committed(tpl)]
        assert after[0][2] == 6
        return [fenced, before, after]

    return await _with_broker(ms, run)


async def kafka_group_ops_on_unknown_group(ms):
    k = sub(ms, "kafka")

    async def run():
        admin = await _cfg(ms).create(k.AdminClient)
        await admin.create_topics([k.NewTopic.new("g7", 1)])
        c = await _gcfg(ms, "nojoin", auto=False).create(k.BaseConsumer)
        tpl = k.TopicPartitionList().add_partition("g7", 0)
        err = await _status(c.committed(tpl), k.KafkaError)
        assert "unknown group" in err[2]
        return err

    return await _with_broker(ms, run)


async def kafka_group_interleaving(ms):
    """The group consumption interleaving of the reference's group
    determinism test."""
    k = sub(ms, "kafka")

    async def run():
        admin = await _cfg(ms).create(k.AdminClient)
        await admin.create_topics([k.NewTopic.new("g5", 3)])
        producer = await _cfg(ms).create(k.FutureProducer)
        for i in range(9):
            await producer.send(k.BaseRecord.to("g5").with_payload(f"m{i}"))
        a = await _gcfg(ms, "grp5").create(k.BaseConsumer)
        b = await _gcfg(ms, "grp5").create(k.BaseConsumer)
        await a.subscribe(["g5"])
        await b.subscribe(["g5"])
        log = []
        for _ in range(18):
            m = await a.poll(timeout_s=0.1)
            if m:
                log.append(("a", m.partition, m.offset))
            m = await b.poll(timeout_s=0.1)
            if m:
                log.append(("b", m.partition, m.offset))
        return log

    return await _with_broker(ms, run)


async def kafka_smoke(ms):
    """Phase 18 (c)'s Kafka program: keyed and keyless produce, a group of
    two with a rebalance and commits, watermarks."""
    k = sub(ms, "kafka")

    async def run():
        admin = await _cfg(ms).create(k.AdminClient)
        await admin.create_topics([k.NewTopic.new("s", 3)])
        producer = await _cfg(ms).create(k.FutureProducer)
        sent = []
        for i in range(9):
            rec = k.BaseRecord.to("s").with_payload(f"m{i}")
            if i % 3 == 0:
                rec = rec.with_key(f"k{ms.rand.gen_range(0, 3)}")
            sent.append(tuple(await producer.send(rec)))
        a = await _gcfg(ms, "g").create(k.BaseConsumer)
        await a.subscribe(["s"])
        log = []
        for _ in range(ms.rand.gen_range(1, 5)):
            m = await a.poll(timeout_s=0.1)
            if m:
                log.append(("a", m.partition, m.offset))
        b = await _gcfg(ms, "g").create(k.BaseConsumer)
        await b.subscribe(["s"])
        for _ in range(12):
            for name, c in (("a", a), ("b", b)):
                m = await c.poll(timeout_s=0.1)
                if m:
                    log.append((name, m.partition, m.offset))
        await a.unsubscribe()
        marks = [tuple(await b.fetch_watermarks("s", p)) for p in range(3)]
        return [sent, log, marks]

    return await _with_broker(ms, run)


# ---------------------------------------------------------------------------
# S3 (tests/test_s3.py)

S_ADDR = "10.0.0.1:9000"


async def _with_s3(ms, client_fn):
    s3 = sub(ms, "s3")
    h = ms.current_handle()
    h.create_node().name("s3").ip("10.0.0.1").init(lambda: s3.SimServer().serve(S_ADDR)).build()
    node = h.create_node().name("client").ip("10.0.0.2").build()
    await ms.sleep(0.1)
    return await node.spawn(client_fn())


async def _s3_error(coro, s3) -> str:
    try:
        await coro
    except s3.S3Error as e:
        return e.code
    raise AssertionError("the call did not raise")


async def s3_object_crud_and_head(ms):
    s3 = sub(ms, "s3")

    async def run():
        c = s3.Client.from_addr(S_ADDR)
        await c.create_bucket().bucket("b").send()
        put = await c.put_object().bucket("b").key("k").body(b"hello").send()
        assert put.e_tag().startswith('"')
        got = await c.get_object().bucket("b").key("k").send()
        body = (await got.body.collect()).into_bytes()
        assert body == b"hello" and got.e_tag() == put.e_tag()
        head = await c.head_object().bucket("b").key("k").send()
        assert head.content_length() == 5 and head.e_tag() == put.e_tag()
        await c.delete_object().bucket("b").key("k").send()
        code = await _s3_error(c.get_object().bucket("b").key("k").send(), s3)
        assert code == "NoSuchKey"
        return [put.e_tag(), body, head.content_length(), code]

    return await _with_s3(ms, run)


async def s3_error_codes(ms):
    s3 = sub(ms, "s3")

    async def run():
        c = s3.Client.from_addr(S_ADDR)
        codes = [await _s3_error(c.put_object().bucket("nope").key("k").body(b"x").send(), s3)]
        await c.create_bucket().bucket("b").send()
        codes.append(await _s3_error(c.create_bucket().bucket("b").send(), s3))
        await c.put_object().bucket("b").key("k").body(b"x").send()
        codes.append(await _s3_error(c.delete_bucket().bucket("b").send(), s3))
        assert codes == ["NoSuchBucket", "BucketAlreadyExists", "BucketNotEmpty"]
        return codes

    return await _with_s3(ms, run)


async def s3_list_objects_v2_pagination(ms):
    s3 = sub(ms, "s3")

    async def run():
        c = s3.Client.from_addr(S_ADDR)
        await c.create_bucket().bucket("b").send()
        for i in range(7):
            await c.put_object().bucket("b").key(f"logs/{i}").body(b"x" * i).send()
        await c.put_object().bucket("b").key("other").body(b"y").send()
        out = await c.list_objects_v2().bucket("b").prefix("logs/").max_keys(3).send()
        keys = [o.key() for o in out.contents()]
        assert keys == ["logs/0", "logs/1", "logs/2"] and out.is_truncated()
        out2 = await (c.list_objects_v2().bucket("b").prefix("logs/").max_keys(10)
                      .continuation_token(out.next_continuation_token()).send())
        keys2 = [o.key() for o in out2.contents()]
        assert keys2 == [f"logs/{i}" for i in range(3, 7)] and not out2.is_truncated()
        delete = s3.Delete.builder()
        for i in range(7):
            delete.objects(s3.ObjectIdentifier.builder().key(f"logs/{i}").build())
        out3 = await c.delete_objects().bucket("b").delete(delete.build()).send()
        assert len(out3.deleted()) == 7
        left = (await c.list_objects_v2().bucket("b").prefix("").send()).key_count()
        assert left == 1
        return [keys, out.next_continuation_token(), keys2, len(out3.deleted()), left]

    return await _with_s3(ms, run)


async def _multipart(ms, c, key: str, chunks) -> list:
    s3 = sub(ms, "s3")
    up = await c.create_multipart_upload().bucket("b").key(key).send()
    uid = up.upload_id()
    etags = {}
    for n, chunk in chunks:
        part = await (c.upload_part().bucket("b").key(key).upload_id(uid).part_number(n)
                      .body(s3.ByteStream.from_static(chunk)).send())
        etags[n] = part.e_tag()
    mp = s3.CompletedMultipartUpload.builder()
    for n, _ in chunks:
        mp.parts(s3.CompletedPart.builder().part_number(n).e_tag(etags[n]).build())
    await (c.complete_multipart_upload().bucket("b").key(key).upload_id(uid)
           .multipart_upload(mp.build()).send())
    return [uid, sorted(etags.items())]


async def s3_multipart_upload_lifecycle(ms):
    s3 = sub(ms, "s3")

    async def run():
        c = s3.Client.from_addr(S_ADDR)
        await c.create_bucket().bucket("b").send()
        uid, etags = await _multipart(ms, c, "big", [(1, b"aaa"), (2, b"bbb"), (3, b"ccc")])
        got = await c.get_object().bucket("b").key("big").send()
        body = (await got.body.collect()).into_bytes()
        assert body == b"aaabbbccc"
        gone = await _s3_error(c.abort_multipart_upload().bucket("b").upload_id(uid).send(), s3)
        assert gone == "NoSuchUpload"
        up2 = await c.create_multipart_upload().bucket("b").key("gone").send()
        await c.abort_multipart_upload().bucket("b").upload_id(up2.upload_id()).send()
        missing = await _s3_error(c.get_object().bucket("b").key("gone").send(), s3)
        return [uid, etags, body, gone, missing]

    return await _with_s3(ms, run)


async def s3_bucket_lifecycle_configuration(ms):
    s3 = sub(ms, "s3")

    async def run():
        c = s3.Client.from_addr(S_ADDR)
        await c.create_bucket().bucket("b").send()
        none = await _s3_error(c.get_bucket_lifecycle_configuration().bucket("b").send(), s3)
        assert none == "NoSuchLifecycleConfiguration"
        rules = [{"id": "expire-logs", "prefix": "logs/", "days": 30}]
        await c.put_bucket_lifecycle_configuration().bucket("b").lifecycle_configuration(
            rules).send()
        out = await c.get_bucket_lifecycle_configuration().bucket("b").send()
        assert out.rules() == rules
        return [none, out.rules()]

    return await _with_s3(ms, run)


async def s3_determinism_workload(ms):
    s3 = sub(ms, "s3")

    async def run():
        c = s3.Client.from_addr(S_ADDR)
        await c.create_bucket().bucket("b").send()
        for i in range(5):
            await c.put_object().bucket("b").key(f"k{i}").body(b"v").send()
        out = await c.list_objects_v2().bucket("b").prefix("k").send()
        assert out.key_count() == 5
        return [o.key() for o in out.contents()]

    return await _with_s3(ms, run)


async def s3_smoke(ms):
    """Phase 18 (c)'s S3 program: puts of seeded sizes, a paged listing, a
    multipart upload and a batch delete."""
    s3 = sub(ms, "s3")

    async def run():
        c = s3.Client.from_addr(S_ADDR)
        await c.create_bucket().bucket("b").send()
        tags = []
        for i in range(6):
            size = ms.rand.gen_range(0, 64)
            tags.append((await c.put_object().bucket("b").key(f"o/{i}").body(
                bytes([i]) * size).send()).e_tag())
        page = await c.list_objects_v2().bucket("b").prefix("o/").max_keys(4).send()
        mp = await _multipart(ms, c, "big", [(n, bytes([n]) * ms.rand.gen_range(1, 32))
                                             for n in (1, 2, 3)])
        body = (await (await c.get_object().bucket("b").key("big").send()).body.collect()
                ).into_bytes()
        delete = s3.Delete.builder()
        for i in range(6):
            delete.objects(s3.ObjectIdentifier.builder().key(f"o/{i}").build())
        deleted = len((await c.delete_objects().bucket("b").delete(delete.build()).send()
                       ).deleted())
        return [tags, [o.key() for o in page.contents()], mp, len(body), deleted]

    return await _with_s3(ms, run)


# ---------------------------------------------------------------------------
# tokio (tests/test_aux.py:21-69)


async def tokio_runtime_aborts_spawned_on_shutdown(ms):
    tokio = sub(ms, "tokio")
    trt = tokio.runtime.Builder.new_multi_thread().enable_all().build()
    progress = []

    async def worker():
        try:
            while True:
                await tokio.time.sleep(0.01)
                progress.append(1)
        finally:
            progress.append("dropped")

    trt.spawn(worker())
    await ms.sleep(0.1)
    before = len(progress)
    assert before > 3
    trt.shutdown()
    await ms.sleep(0.1)
    assert progress[-1] == "dropped"
    n_after = len(progress)
    await ms.sleep(0.1)
    assert len(progress) == n_after
    try:
        trt.spawn(worker())
    except RuntimeError as e:
        refused = str(e)
    assert "shut down" in refused
    return [before, n_after, refused]


async def tokio_block_on_is_an_error_in_sim(ms):
    tokio = sub(ms, "tokio")
    trt = tokio.runtime.Builder().build()
    try:
        trt.block_on(None)
    except RuntimeError as e:
        msg = str(e)
    assert "block_on" in msg
    return msg


async def tokio_smoke(ms):
    """Phase 18 (c)'s tokio program: a runtime's spawned workers over
    channels and timers, aborted on shutdown."""
    tokio = sub(ms, "tokio")
    trt = tokio.runtime.Builder.new_multi_thread().enable_all().build()
    tx, rx = tokio.sync.channel(8)
    ticks = []

    async def producer(i):
        for j in range(5):
            await tokio.time.sleep(ms.rand.uniform(0.001, 0.02))
            await tx.send((i, j))

    async def ticker():
        iv = tokio.time.interval(0.005)
        while True:
            ticks.append((await iv.tick()).ns)

    for i in range(3):
        trt.spawn(producer(i))
    trt.spawn(ticker())
    got = [await rx.recv() for _ in range(15)]
    trt.shutdown()
    await ms.sleep(0.05)
    n = len(ticks)
    await ms.sleep(0.05)
    assert len(ticks) == n
    return [got, ticks]


# ---------------------------------------------------------------------------
# the registries

PROGRAMS = {
    # name: (program, seed of the reference test)
    "grpc_all_streaming_modes": (grpc_all_streaming_modes, 10),
    "grpc_client_crash_loop": (grpc_client_crash_loop, 11),
    "grpc_server_crash_mid_stream": (grpc_server_crash_mid_stream, 12),
    "grpc_unimplemented_service": (grpc_unimplemented_service, 13),
    "grpc_interceptor": (grpc_interceptor, 14),
    "grpc_request_timeout": (grpc_request_timeout, 15),
    "grpc_balance_list": (grpc_balance_list, 16),
    "grpc_determinism_workload": (grpc_determinism_workload, 77),
    "grpc_invalid_address": (grpc_invalid_address, 77),
    "grpc_client_drops_response_stream": (grpc_client_drops_response_stream, 78),
    "grpc_balance_channel_dynamic": (grpc_balance_channel_dynamic, 79),
    "etcd_kv_put_get_delete_prefix": (etcd_kv_put_get_delete_prefix, 21),
    "etcd_txn_compare_and_ops": (etcd_txn_compare_and_ops, 22),
    "etcd_lease_expiry_on_sim_time": (etcd_lease_expiry_on_sim_time, 23),
    "etcd_lease_revoke_deletes_keys": (etcd_lease_revoke_deletes_keys, 24),
    "etcd_election_campaign_observe_resign": (etcd_election_campaign_observe_resign, 25),
    "etcd_request_too_large": (etcd_request_too_large, 26),
    "etcd_timeout_rate_injection": (etcd_timeout_rate_injection, 27),
    "etcd_dump_load_snapshot_restore": (etcd_dump_load_snapshot_restore, 28),
    "etcd_watch_prefix_stream": (etcd_watch_prefix_stream, 29),
    "etcd_determinism_workload": (etcd_determinism_workload, 31),
    "etcd_maintenance_status": (etcd_maintenance_status, 97),
    "kafka_produce_consume_round_robin": (kafka_produce_consume_round_robin, 41),
    "kafka_keyed_produce_is_sticky": (kafka_keyed_produce_is_sticky, 42),
    "kafka_base_producer_buffers_until_flush": (kafka_base_producer_buffers_until_flush, 43),
    "kafka_watermarks_seek_offsets_for_times": (kafka_watermarks_seek_offsets_for_times, 44),
    "kafka_fetch_byte_budget": (kafka_fetch_byte_budget, 45),
    "kafka_stream_consumer_and_linger": (kafka_stream_consumer_and_linger, 46),
    "kafka_broker_crash_restart": (kafka_broker_crash_restart, 47),
    "kafka_two_producers_two_consumers": (kafka_two_producers_two_consumers, 48),
    "kafka_determinism_workload": (kafka_determinism_workload, 49),
    "kafka_group_splits_partitions": (kafka_group_splits_partitions, 900),
    "kafka_group_rebalance_on_join_and_leave": (kafka_group_rebalance_on_join_and_leave, 901),
    "kafka_group_commit_and_resume": (kafka_group_commit_and_resume, 902),
    "kafka_group_auto_commit_on_unsubscribe": (kafka_group_auto_commit_on_unsubscribe, 903),
    "kafka_group_commits_before_revoke": (kafka_group_commits_before_revoke, 904),
    "kafka_group_commit_generation_fencing": (kafka_group_commit_generation_fencing, 906),
    "kafka_group_ops_on_unknown_group": (kafka_group_ops_on_unknown_group, 905),
    "kafka_group_interleaving": (kafka_group_interleaving, 77),
    "s3_object_crud_and_head": (s3_object_crud_and_head, 61),
    "s3_error_codes": (s3_error_codes, 62),
    "s3_list_objects_v2_pagination": (s3_list_objects_v2_pagination, 63),
    "s3_multipart_upload_lifecycle": (s3_multipart_upload_lifecycle, 64),
    "s3_bucket_lifecycle_configuration": (s3_bucket_lifecycle_configuration, 65),
    "s3_determinism_workload": (s3_determinism_workload, 66),
    "tokio_runtime_aborts_spawned_on_shutdown": (tokio_runtime_aborts_spawned_on_shutdown, 70),
    "tokio_block_on_is_an_error_in_sim": (tokio_block_on_is_an_error_in_sim, 71),
}

# the reference's tests that run their workload through check_determinism
DETERMINISM = {
    "grpc_determinism_workload": 77,
    "etcd_determinism_workload": 31,
    "kafka_determinism_workload": 49,
    "s3_determinism_workload": 66,
}


async def kv_store_scenario(ms):
    """The kv_store example's scenario (clog, kill and restart of the
    server under a client's puts); its printed line is the output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        await example(ms, "kv_store").scenario()
    return buf.getvalue()


# phase 18 (c) of chip_smoke.py: one program per shim, each run over seeds
# 0..n-1 on the compiled core
SMOKE = {
    "greeter": grpc_all_streaming_modes,
    "kv_store": kv_store_scenario,
    "etcd": etcd_smoke,
    "kafka": kafka_smoke,
    "s3": s3_smoke,
    "tokio": tokio_smoke,
}


def digest(ms, program, seeds: int) -> dict:
    """``program`` over seeds ``0..seeds-1``: the sha256 of the
    determinism logs, of the outputs' ``repr`` and the final virtual ns
    and draw count of every seed."""
    logs, outs = hashlib.sha256(), hashlib.sha256()
    now_ns, draws = [], []
    for seed in range(seeds):
        r = record(ms, program, seed)
        logs.update(json.dumps(r["log"]).encode())
        outs.update(repr(r["out"]).encode())
        now_ns.append(r["now_ns"])
        draws.append(r["draws"])
    return {"seeds": seeds, "log_sha256": logs.hexdigest(), "out_sha256": outs.hexdigest(),
            "now_ns": now_ns, "draws": draws}


def summary(r: dict) -> dict:
    """A run of ``record`` as JSON-safe data: the sha256 of its log and of
    its output's ``repr``, its draws and final virtual ns."""
    return {"log_sha256": hashlib.sha256(json.dumps(r["log"]).encode()).hexdigest(),
            "out_sha256": hashlib.sha256(repr(r["out"]).encode()).hexdigest(),
            "draws": r["draws"], "now_ns": r["now_ns"]}


def port_records(smoke_seeds: int = 8) -> dict:
    """The port's summary of every program at its seed and ``digest`` of
    every ``SMOKE`` program (for comparing the port with itself across
    interpreters, its compiled core on and off)."""
    import madsim_tpu_torch as P

    out = {name: summary(record(P, program, seed))
           for name, (program, seed) in sorted(PROGRAMS.items())}
    out.update({f"smoke/{name}": digest(P, program, smoke_seeds)
                for name, program in sorted(SMOKE.items())})
    return out
