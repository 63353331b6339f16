"""The etcd v3 and S3 wire servers, driven by stock clients — the same
state machines the simulator tests, reachable over their REAL protocols
(docs/real_mode.md).

Run:  python -m madsim_tpu_torch.examples.wire_servers

The port's own copy of the repository's ``examples/wire_servers.py``.

- etcd: a stock gRPC client Puts, Txns, and opens a live Watch at
  /etcdserverpb.{KV,Watch}.
- S3: a stock HTTP client creates a bucket, uploads, and lists at
  path-style REST endpoints (curl works too — see the printed commands).
"""

from __future__ import annotations

import asyncio

from madsim_tpu_torch import real
from madsim_tpu_torch.etcd import wire as etcd_wire
from madsim_tpu_torch.s3 import wire as s3_wire


async def etcd_demo() -> None:
    from grpc import aio as grpc_aio

    server = etcd_wire.WireServer()
    task = real.spawn(server.serve(("127.0.0.1", 0)))
    while server.bound_addr is None:
        if task.done():
            task.result()  # surface bind failures instead of hanging
        await real.sleep(0.005)
    host, port = server.bound_addr
    print(f"etcd v3 gRPC serving on {host}:{port}")

    m = {n.rsplit(".", 1)[-1]: c
         for n, c in etcd_wire.wire_pkg().messages.items()}
    async with grpc_aio.insecure_channel(f"{host}:{port}") as ch:
        put = ch.unary_unary(
            "/etcdserverpb.KV/Put",
            request_serializer=m["PutRequest"].SerializeToString,
            response_deserializer=m["PutResponse"].FromString,
        )
        watch = ch.stream_stream(
            "/etcdserverpb.Watch/Watch",
            request_serializer=m["WatchRequest"].SerializeToString,
            response_deserializer=m["WatchResponse"].FromString,
        )
        q: asyncio.Queue = asyncio.Queue()

        async def reqs():
            while True:
                r = await q.get()
                if r is None:
                    return
                yield r

        it = watch(reqs()).__aiter__()
        await q.put(m["WatchRequest"](
            create_request=m["WatchCreateRequest"](key=b"app/",
                                                   range_end=b"app0")
        ))
        created = await it.__anext__()
        print(f"  watch created (id {created.watch_id})")
        r = await put(m["PutRequest"](key=b"app/config", value=b"v1"))
        print(f"  put app/config at revision {r.header.revision}")
        ev = (await it.__anext__()).events[0]
        print(f"  watch event: PUT {ev.kv.key.decode()} = "
              f"{ev.kv.value.decode()}")
        await q.put(None)
    task.abort()


async def s3_demo() -> None:
    server = s3_wire.WireServer()
    task = real.spawn(server.serve(("127.0.0.1", 0)))
    while server.bound_addr is None:
        if task.done():
            task.result()  # surface bind failures instead of hanging
        await real.sleep(0.005)
    host, port = server.bound_addr
    base = f"http://{host}:{port}"
    print(f"S3 REST serving on {base}")
    print(f"  (try: curl -X PUT {base}/demo; "
          f"curl -X PUT {base}/demo/k -d hi; curl {base}/demo/k)")

    try:
        import aiohttp
    except ImportError:
        print("  aiohttp not installed; skipping the client half")
        task.abort()
        return
    async with aiohttp.ClientSession() as http:
        await http.put(f"{base}/demo")
        r = await http.put(f"{base}/demo/greeting.txt", data=b"hello wire")
        print(f"  put object, ETag {r.headers['ETag']}")
        r = await http.get(f"{base}/demo/greeting.txt")
        print(f"  get object -> {await r.read()}")
        r = await http.get(f"{base}/demo?list-type=2")
        text = await r.text()
        print(f"  list-v2 -> {text[text.index('<Key>'):text.index('</Key>') + 6]}")
    task.abort()


async def main() -> None:
    await etcd_demo()
    await s3_demo()


if __name__ == "__main__":
    real.Runtime().block_on(main())
