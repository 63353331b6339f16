"""Heavy-traffic wire load gate (counterpart of
``scripts/wire_load_demo.py``; host tier, on the CPU by design): N
concurrent Kafka-binary-protocol clients (producers + a consumer group
with a mid-run joiner) hammer the sim-backed broker through the genuine
wire (``kafka/wire.py`` over ``Endpoint`` pipes) while a ``FaultSpec``
latency burst degrades the simulated network — and the whole run is a
determinism statement three ways:

1. the outcome/throughput report is a pure function of the seed:
   ``check_determinism`` runs this twice in two processes and compares
   the report bytes;
2. the wire server itself is a pure function of (frame sequence, clock):
   every recorded (request, clock) pair is re-fed through a fresh broker
   in-process and the responses must be byte-identical (the second
   path), with both paths' transcript digests in the report;
3. the wire-driven operation history (``oracle.HostRecorder`` rows around
   every produce/fetch) must satisfy the kafka ordered-log spec
   (``oracle.specs.LogSpec``).

``--fuzz N`` instead runs N seeds of the kafka differential fuzz
(``kafka/fuzz.py``, loopback codec) and reports per-seed digests — the
fuzz half of the gate's wire leg.

Usage, from the repository root:
    python -m madsim_tpu_torch.scripts.wire_load_demo [--seed 0] [--report out.json]
    python -m madsim_tpu_torch.scripts.wire_load_demo --fuzz 12 --report fuzz.json
"""

import argparse
import asyncio
import hashlib
import json
import sys

BROKER = "10.0.0.1:9092"
TOPIC = "load"
GROUP = "load-group"


def run_load(args) -> dict:
    import madsim_tpu_torch as ms
    from .. import faults as hfaults
    from ..engine.faults import FaultSpec
    from ..kafka import wire
    from ..kafka.broker import Broker
    from ..kafka.probe import ProbeClient, SimTransport
    from ..oracle import HostRecorder, check_history
    from ..oracle.history import OP_FETCH, OP_PRODUCE
    from ..oracle.specs import LogSpec

    spec = FaultSpec(
        spikes=2,
        spike_window_ns=2_000_000_000,
        spike_dur_lo_ns=200_000_000,
        spike_dur_hi_ns=600_000_000,
        spike_lat_lo_ns=20_000_000,
        spike_lat_hi_ns=80_000_000,
    )
    total = args.producers * args.records
    rt = ms.Runtime(seed=args.seed)

    async def main():
        h = ms.current_handle()
        server = wire.SimWireServer()
        broker_node = (
            h.create_node().name("broker").ip("10.0.0.1")
            .init(lambda: server.serve(BROKER)).build()
        )
        client_node = h.create_node().name("clients").ip("10.0.0.2").build()
        await ms.sleep(0.05)
        server.wire.recorder = transcript = []

        schedule = hfaults.compile_host(spec, num_nodes=1, seed=args.seed)
        ms.spawn(hfaults.apply_schedule(schedule, [broker_node], spec=spec))

        rec = HostRecorder()
        produced = [0] * args.producers
        consumed = {}  # consumer -> unique records fetched
        state = {"producing": args.producers}

        async def setup():
            c = ProbeClient(await SimTransport.connect(BROKER))
            out = await c.create_topics([(TOPIC, args.partitions)])
            assert out[0][1] == 0, out
            c.close()

        async def producer(i: int):
            c = ProbeClient(await SimTransport.connect(BROKER))
            for r in range(args.records):
                seq = i * args.records + r
                p = seq % args.partitions
                now = h.time.now_time_ns() // 1_000_000
                opid = rec.invoke(client=i, op=OP_PRODUCE, key=p, inp=seq)
                err, off = await c.produce(
                    TOPIC, p,
                    [(now, b"p%d" % i, b"r%d" % seq)],
                )
                assert err == 0, (i, r, err)
                rec.complete(client=i, opid=opid, out=off + 1)
                produced[i] += 1
                await ms.sleep(0.002)
            state["producing"] -= 1
            c.close()

        async def consumer(i: int, member_id: str = "", late: bool = False):
            if late:
                await ms.sleep(0.4)  # joins mid-run: a live rebalance
            cid = args.producers + i  # history client ids after producers
            c = ProbeClient(await SimTransport.connect(BROKER))
            member, gen, assignment = await c.group_session(
                GROUP, [TOPIC], member_id=member_id
            )
            positions = {}
            seen = 0
            while True:
                progressed = False
                for topic, p in assignment:
                    offset = positions.get(p, 0)
                    opid = rec.invoke(client=cid, op=OP_FETCH, key=p,
                                      inp=offset)
                    err, high, rows = await c.fetch(topic, p, offset)
                    assert err == 0
                    rec.complete(client=cid, opid=opid, out=len(rows))
                    if rows:
                        positions[p] = rows[-1][0] + 1
                        seen += len(rows)
                        progressed = True
                hb = await c.heartbeat(GROUP, gen, member)
                if hb == wire.ERR_REBALANCE_IN_PROGRESS:
                    member, gen, assignment = await c.group_session(
                        GROUP, [TOPIC], member_id=member
                    )
                    # keep per-(client, partition) fetches contiguous for
                    # the LogSpec structural check: carried partitions
                    # continue, newly adopted ones restart from 0
                    positions = {p: positions.get(p, 0)
                                 for _t, p in assignment}
                elif hb == 0:
                    await c.offset_commit(
                        GROUP, gen, member,
                        [(TOPIC, p, off) for p, off in sorted(
                            positions.items())],
                    )
                if state["producing"] == 0 and not progressed:
                    caught_up = True
                    for _topic, p in assignment:
                        err, _ts, high = await c.list_offsets(TOPIC, p, -1)
                        if positions.get(p, 0) < high:
                            caught_up = False
                    if caught_up:
                        break
                await ms.sleep(0.01)
            consumed[f"c{i}"] = seen
            if late:
                await c.leave_group(GROUP, member)
            c.close()

        await client_node.spawn(setup())
        tasks = [client_node.spawn(producer(i))
                 for i in range(args.producers)]
        tasks += [client_node.spawn(consumer(i))
                  for i in range(args.consumers)]
        tasks += [client_node.spawn(consumer(args.consumers, late=True))]
        for t in tasks:
            await t

        # per-partition final highs via one more wire client
        c = ProbeClient(await SimTransport.connect(BROKER))
        highs = {}
        for p in range(args.partitions):
            err, _ts, high = await c.list_offsets(TOPIC, p, -1)
            assert err == 0
            highs[str(p)] = high
        committed = await c.offset_fetch(
            GROUP, [(TOPIC, p) for p in range(args.partitions)]
        )
        c.close()

        result = check_history(rec.history(), LogSpec())
        assert result.ok, f"LogSpec violation under load: {result.reason}"

        # path 2: replay every recorded (frame, clock) pair through a
        # FRESH broker — the wire server is pure, so every response byte
        # must reproduce
        clock_feed = [now for _req, now, _rsp in transcript]
        replay = wire.KafkaWire(
            Broker(), clock_ms=lambda: clock_feed.pop(0),
            advertised=server.bound_addr,
        )
        live = hashlib.sha256()
        replayed = hashlib.sha256()
        for req, _now, rsp in transcript:
            got = replay.handle_frame(req)
            assert got == rsp, "wire replay diverged from the live serve"
            live.update(req + (rsp or b"\x00"))
            replayed.update(req + (got or b"\x00"))

        return {
            "seed": args.seed,
            "producers": args.producers,
            "consumers": args.consumers + 1,
            "partitions": args.partitions,
            "records": total,
            "produced": produced,
            "consumed": dict(sorted(consumed.items())),
            "highs": highs,
            "committed": [[t, p, o] for t, p, o in committed],
            "history_ops": len(rec.history().ops),
            "history_ok": bool(result.ok),
            "fault_events": len(schedule),
            "elapsed_virtual_ns": h.time.now_time_ns(),
            "frames": len(transcript),
            "transcript_sha256": live.hexdigest(),
            "replay_sha256": replayed.hexdigest(),
            "replay_ok": live.hexdigest() == replayed.hexdigest(),
        }

    report = rt.block_on(main())
    assert sum(report["highs"].values()) == total
    return report


def run_fuzz(args) -> dict:
    from ..kafka import fuzz as kfuzz
    from ..kafka.probe import LoopbackTransport, ProbeClient
    from ..kafka.wire import KafkaWire

    async def main():
        digests = {}
        for seed in range(args.fuzz):
            client = ProbeClient(LoopbackTransport(KafkaWire()))
            digests[str(seed)] = await kfuzz.fuzz_seed(seed, client, ops=30)
        return digests

    return {"fuzz_seeds": args.fuzz, "digests": asyncio.run(main())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="wire_load_demo", description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--producers", type=int, default=3)
    ap.add_argument("--consumers", type=int, default=2,
                    help="steady group members (one more joins mid-run)")
    ap.add_argument("--partitions", type=int, default=3)
    ap.add_argument("--records", type=int, default=16,
                    help="records per producer")
    ap.add_argument("--fuzz", type=int, default=0,
                    help="run N differential-fuzz seeds instead of the load")
    ap.add_argument("--report", default=None)
    args = ap.parse_args(argv)

    report = run_fuzz(args) if args.fuzz else run_load(args)
    text = json.dumps(report, sort_keys=True, indent=2) + "\n"
    if args.report:
        with open(args.report, "w") as f:
            f.write(text)
    sys.stdout.write(text)
    if not args.fuzz:
        ok = report["replay_ok"] and report["history_ok"]
        print(f"wire load gate: {'OK' if ok else 'FAILED'} "
              f"({report['frames']} frames, {report['records']} records, "
              f"{report['fault_events']} fault events)")
        return 0 if ok else 1
    print(f"wire fuzz: OK ({args.fuzz} seeds)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
