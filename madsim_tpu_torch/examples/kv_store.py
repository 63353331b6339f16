"""Example: a tiny replicated KV service tested under deterministic simulation
(the port's own copy of ``examples/kv_store.py``).

A primary node serves Put/Get RPCs; a flaky client hammers it while the test
harness injects faults (node kill/restart, link clog).  Run it:

    python -m madsim_tpu_torch.examples.kv_store             # 5-seed sweep
    MADSIM_TEST_SEED=7 python -m madsim_tpu_torch.examples.kv_store   # one seed

The analogue of the reference's examples/rpc.rs demo (madsim/examples/rpc.rs).
"""

import madsim_tpu_torch as ms
from madsim_tpu_torch.net import Endpoint, NetSim, Request
from madsim_tpu_torch.plugin import simulator


class Put(Request):
    def __init__(self, key, value):
        self.key, self.value = key, value


class Get(Request):
    def __init__(self, key):
        self.key = key


def server_init():
    async def body():
        store = {}
        ep = await Endpoint.bind("10.0.0.100:50051")

        async def put(req):
            store[req.key] = req.value
            return "ok"

        async def get(req):
            return store.get(req.key)

        ep.add_rpc_handler(Put, put)
        ep.add_rpc_handler(Get, get)
        await ms.futures.pending_forever()

    return body()


async def scenario():
    h = ms.current_handle()
    seed = h.seed
    server = (
        h.create_node().name("kv-server").ip("10.0.0.100").init(server_init).build()
    )
    client = h.create_node().name("client").ip("10.0.0.200").build()
    net = simulator(NetSim)

    async def client_body():
        ep = await Endpoint.bind("0.0.0.0:0")
        await ms.sleep(0.5)
        ok = 0
        for i in range(20):
            try:
                await ep.call_timeout("10.0.0.100:50051", Put(f"k{i}", i), 2.0)
                ok += 1
            except ms.TimeoutError:
                pass
            await ms.sleep(0.2)
        return ok

    work = client.spawn(client_body())

    # fault schedule: clog the server for a while, then kill + restart it
    await ms.sleep(1.0)
    net.clog_node(server.id)
    await ms.sleep(1.0)
    net.unclog_node(server.id)
    await ms.sleep(0.5)
    h.kill(server)
    await ms.sleep(0.5)
    h.restart(server)

    ok = await work
    print(
        f"seed={seed} sim_time={ms.time.elapsed():.3f}s "
        f"puts_ok={ok}/20 msgs={net.stat().msg_count}"
    )
    assert ok >= 10, "too many failures even for this fault schedule"


if __name__ == "__main__":
    import os

    overrides = {}
    if "MADSIM_TEST_NUM" not in os.environ and "MADSIM_TEST_SEED" not in os.environ:
        overrides["count"] = 5  # default: a small sweep of fresh seeds
    ms.Builder.from_env(**overrides).run(scenario)
