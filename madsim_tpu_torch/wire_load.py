"""The async-core wire load rig (docs/wire.md "Async serving core").

Run from the repository root:

    python -m madsim_tpu_torch.wire_load [--smoke | --determinism] [--report FILE]

Three modes against one sim-backed cluster (Kafka binary wire + S3 REST
wire + framed etcd wire, all multiplexed by ``serve.core``):

  (default)       full load: worker PROCESSES running >=1k genuine-
                  protocol asyncio clients, gray failure injected
                  mid-run (asymmetric partition during a consumer-group
                  rebalance; fsync stall under S3 multipart), histories
                  checked against LogSpec/S3Spec/KVSpec, the Kafka and
                  S3 transcripts replayed through fresh engines byte
                  for byte, SLO report from the server-side histograms.

  --smoke         the same rig at small scale (``SMOKE_SCENARIO``) plus
                  an in-process async-vs-legacy transcript parity check;
                  ``--report`` gets the load report with its gate
                  failures and the parity verdict.

  --determinism   a seeded SEQUENTIAL transcript (injected clocks, one
                  op at a time): the report carries per-wire response
                  hashes and op counts and nothing else, so two
                  processes x {--server async, --server legacy} x
                  {--telemetry on/off} must all emit byte-identical
                  reports.

Exit 0 iff every gate in the chosen mode holds. The process never
imports torch: the chaos schedule compiles in a forked child
(``loadgen.chaos_plan``), and the load workers fork from this process.
"""

import argparse
import asyncio
import hashlib
import json
import random
import sys

from .serve import loadgen


# ---------------------------------------------------------------------------
# determinism mode: seeded sequential transcripts, injected clocks


class _Counter:
    """A deterministic ms clock: strictly increasing, process-independent."""

    def __init__(self, start: int = 1_000_000):
        self.t = start

    def __call__(self) -> int:
        self.t += 1
        return self.t


async def _det_kafka(addr, seed: int) -> int:
    from .kafka.probe import ProbeClient, RealTransport

    rng = random.Random(seed * 31 + 1)
    c = ProbeClient(await RealTransport.connect(addr))
    try:
        await c.api_versions()
        await c.create_topics([("det", 4)])
        await c.metadata(["det"])
        offsets = [0, 0, 0, 0]
        n = 0
        for _ in range(40):
            part = rng.randrange(4)
            kind = rng.randrange(3)
            if kind == 0:
                await c.produce(
                    "det", part,
                    [(1_000_000 + n, b"k%d" % rng.randrange(16),
                      b"v%d" % rng.randrange(1 << 20))],
                )
            elif kind == 1:
                err, _high, rows = await c.fetch("det", part, offsets[part])
                if not err and rows:
                    offsets[part] = rows[-1][0] + 1
            else:
                await c.list_offsets("det", part, -1)
            n += 1
        return n + 3
    finally:
        c.close()


async def _det_s3(addr, seed: int) -> int:
    rng = random.Random(seed * 31 + 2)
    c = loadgen._HttpClient(*addr)
    await c.connect()
    try:
        await c.request("PUT", "/det")
        n = 1
        for i in range(30):
            key = "k%d" % rng.randrange(8)
            kind = rng.randrange(4)
            if kind == 0:
                await c.request(
                    "PUT", f"/det/{key}", b"b%d" % rng.randrange(1 << 20)
                )
                n += 1
            elif kind == 1:
                await c.request("GET", f"/det/{key}")
                n += 1
            elif kind == 2:
                await c.request("DELETE", f"/det/{key}")
                n += 1
            else:
                ok = await loadgen._s3_multipart(
                    c, key, b"m%d" % rng.randrange(1 << 20)
                )
                # 4 requests when the lifecycle completes; count them
                # via the recorder, not here
                n += 4 if ok else 0
        return n
    finally:
        c.close()


async def _det_etcd(addr, seed: int):
    from .real import etcd as retcd

    rng = random.Random(seed * 31 + 3)
    client = await retcd.Client.connect([f"{addr[0]}:{addr[1]}"])
    h = hashlib.sha256()
    n = 0
    for _ in range(30):
        key = b"k%d" % rng.randrange(8)
        kind = rng.randrange(3)
        if kind == 0:
            rsp = await client.put(key, b"v%d" % rng.randrange(1 << 20))
            h.update(b"put:%d;" % rsp.header().revision())
        elif kind == 1:
            rsp = await client.get(key)
            kvs = [(kv.key, kv.value) for kv in rsp.kvs()]
            h.update(b"get:%d:%r;" % (rsp.count(), kvs))
        else:
            rsp = await client.delete(key)
            h.update(b"del;")
        n += 1
    return n, h.hexdigest()


async def _determinism_async(server_kind: str, seed: int,
                             telemetry: bool) -> dict:
    cluster = loadgen.Cluster(
        server_kind=server_kind,
        kafka_clock=_Counter(), s3_clock=_Counter(),
        telemetry=telemetry,
        kafka_advertised=("127.0.0.1", 9092),
    )
    addrs = await cluster.start()
    try:
        kafka_n = await _det_kafka(addrs["kafka"], seed)
        s3_n = await _det_s3(addrs["s3"], seed)
        etcd_n, etcd_hash = await _det_etcd(addrs["etcd"], seed)

        kh = hashlib.sha256()
        for req, clk, rsp in cluster.kafka.wire.recorder:
            kh.update(req)
            kh.update(rsp if rsp is not None else b"\x00")
            kh.update(b"%d" % clk)
        sh = hashlib.sha256()
        for req, clk, (status, body, headers) in cluster.s3.rest.recorder:
            sh.update(
                f"{req.method} {req.path} {status} {clk} "
                f"{sorted(headers.items())}".encode()
            )
            sh.update(body)
        # the replay gate runs here too: determinism mode must satisfy
        # the same live-vs-replay contract as the full rig
        _, kafka_replay_ok = cluster.replay_kafka()
        _, s3_replay_ok = cluster.replay_s3()
        return {
            "seed": seed,
            "kafka": {
                "frames": len(cluster.kafka.wire.recorder),
                "client_ops": kafka_n,
                "sha256": kh.hexdigest(),
                "replay_ok": kafka_replay_ok,
            },
            "s3": {
                "requests": len(cluster.s3.rest.recorder),
                "client_ops": s3_n,
                "sha256": sh.hexdigest(),
                "replay_ok": s3_replay_ok,
            },
            "etcd": {"ops": etcd_n, "sha256": etcd_hash},
        }
    finally:
        await cluster.stop()


def run_determinism(args) -> int:
    report = asyncio.run(
        _determinism_async(args.server, args.seed, args.telemetry)
    )
    blob = json.dumps(report, sort_keys=True, indent=1) + "\n"
    if args.report:
        with open(args.report, "w") as f:
            f.write(blob)
    sys.stdout.write(blob)
    ok = report["kafka"]["replay_ok"] and report["s3"]["replay_ok"]
    print(f"wire_load determinism [{args.server}]: "
          f"{'OK' if ok else 'FAILED'}")
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# full / smoke modes


def _gate(report: dict, min_clients: int) -> list:
    failures = []
    if report["clients"] < min_clients:
        failures.append(
            f"clients {report['clients']} < {min_clients}"
        )
    if not report["histories_ok"]:
        failures.append(f"history check failed: {report['history_checks']}")
    if not report["replay_ok"]:
        failures.append(f"replay mismatch: {report['replay']}")
    if report["missing_workers"]:
        failures.append(f"{report['missing_workers']} worker(s) missing")
    if report["fatals"]:
        failures.append(f"worker fatals: {report['fatals']}")
    total = report["total_ops"]
    if total and report["stats"]["errors"] > total * 0.25:
        failures.append(
            f"error rate {report['stats']['errors']}/{total} above 25%"
        )
    return failures


def run_full(args) -> int:
    cfg = dict(loadgen.DEFAULT_SCENARIO)
    if args.clients:
        scale = args.clients / loadgen.total_clients(cfg)
        for k in ("kafka_producers", "s3_clients", "etcd_clients"):
            cfg[k] = max(1, int(cfg[k] * scale))
    if args.run_secs:
        cfg["run_secs"] = args.run_secs
    cfg["seed"] = args.seed
    report = loadgen.run_load(cfg, server_kind=args.server)
    failures = _gate(report, min_clients=args.min_clients)
    report["gate_failures"] = failures
    blob = json.dumps(report, sort_keys=True, indent=1) + "\n"
    if args.report:
        with open(args.report, "w") as f:
            f.write(blob)
    sys.stdout.write(blob)
    print(f"wire_load [{report['clients']} clients, "
          f"{report['total_ops']} ops, "
          f"{report['throughput_ops_s']} ops/s, "
          f"peak {report['peak_open_conns']} conns]: "
          f"{'OK' if not failures else 'FAILED: ' + '; '.join(failures)}")
    return 0 if not failures else 1


def run_smoke(args) -> int:
    # leg 1: the concurrent rig at small scale through the async core
    cfg = dict(loadgen.SMOKE_SCENARIO, seed=args.seed)
    report = loadgen.run_load(cfg, server_kind="async")
    failures = _gate(report, min_clients=loadgen.total_clients(cfg) // 2)
    print(f"smoke load [{report['clients']} clients, "
          f"{report['total_ops']} ops]: "
          f"{'OK' if not failures else 'FAILED: ' + '; '.join(failures)}")

    # leg 2: adapter parity — the async core and the legacy thread-of-
    # control servers must produce the SAME seeded sequential transcript
    a = asyncio.run(_determinism_async("async", args.seed, True))
    b = asyncio.run(_determinism_async("legacy", args.seed, False))
    parity = a == b
    print(f"smoke parity [async vs legacy, telemetry on vs off]: "
          f"{'OK' if parity else 'FAILED'}")
    if not parity:
        for wire in ("kafka", "s3", "etcd"):
            if a[wire] != b[wire]:
                print(f"  {wire}: async={a[wire]} legacy={b[wire]}")
    if args.report:
        report["gate_failures"] = failures
        with open(args.report, "w") as f:
            f.write(json.dumps({"load": report, "parity": parity}, sort_keys=True,
                               indent=1) + "\n")
    return 0 if not failures and parity else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--determinism", action="store_true")
    ap.add_argument("--server", choices=("async", "legacy"),
                    default="async")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry", action="store_true",
                    help="determinism mode: serve with telemetry on "
                         "(report bytes must not change)")
    ap.add_argument("--report", default="")
    ap.add_argument("--clients", type=int, default=0,
                    help="scale the client mix to ~N total clients")
    ap.add_argument("--min-clients", type=int, default=1000)
    ap.add_argument("--run-secs", type=float, default=0.0)
    args = ap.parse_args()
    if args.determinism:
        return run_determinism(args)
    if args.smoke:
        return run_smoke(args)
    return run_full(args)


if __name__ == "__main__":
    sys.exit(main())
