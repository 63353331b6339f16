"""Multi-process load rig: ≥1k genuine-protocol clients against one
sim-backed cluster served by the async core.

The rig runs the wires at production scale rather than demo scale:
a parent process hosts one cluster — the Kafka binary wire, the
S3 REST wire, and the framed etcd wire, all multiplexed by
``serve.core.AsyncWireServer`` over real TCP — while worker *processes*
(``multiprocessing``) run hundreds of asyncio client tasks each,
speaking the real protocols end to end:

- Kafka producers pinned to home partitions + consumer groups (Join/
  Sync/Heartbeat/OffsetCommit) with a late joiner per group forcing a
  live rebalance;
- S3 clients doing PutObject/GetObject/DeleteObject plus the multipart
  lifecycle over keep-alive HTTP/1.1;
- etcd clients doing put/get/delete through the framed request-enum
  tier.

Mid-load gray failure, derived from a compiled ``FaultSpec`` schedule
(``faults.compile_host`` — same host-fault vocabulary as the sim tier):
an **asymmetric partition** (the core stops *reading* half the Kafka
connections while its write half stays live) timed to overlap the
consumer-group rebalance window, and an **fsync stall** on S3 multipart
writes (UploadPart/CompleteMultipartUpload responses withheld without
blocking the loop).

Every client op is recorded through ``oracle.HostRecorder`` rows; the
parent merges per-worker rows into one history per wire and checks them
against ``LogSpec`` (Kafka), ``S3Spec`` (S3), and ``KVSpec`` (etcd).
The standing hard rule holds: the Kafka wire transcript and the S3 REST
transcript are replayed through FRESH engines and must reproduce byte
for byte. SLOs (p50/p99 + throughput per api/op/method) come from the
server-side latency histograms — the internal registry is always
on, so the caller's telemetry setting cannot change any report byte.
"""

from __future__ import annotations

import asyncio
import hashlib
import multiprocessing as mp
import time as _walltime
from typing import Dict, List, Optional, Tuple

from ..obs import Telemetry
from ..obs.metrics import Registry
from ..oracle import KVSpec, LogSpec, S3Spec, check_history
from ..oracle.history import (
    OP_DEL,
    OP_FETCH,
    OP_GET,
    OP_PRODUCE,
    OP_PUT,
    decode_rows,
)

TOPIC = "load"
GROUP_PREFIX = "load-group"
BUCKET = "load"

_I31 = 0x7FFF_FFFF  # history columns are int32


def fingerprint(body: bytes) -> int:
    """31-bit content digest — the S3Spec register value of a body."""
    return int.from_bytes(
        hashlib.sha256(body).digest()[:4], "big"
    ) & _I31


def body_for(client: int, n: int) -> bytes:
    """The deterministic object body client ``client`` writes as its
    ``n``-th value (both the writer and the spec know the fingerprint)."""
    return b"o%d.%d" % (client, n) * 3


# ---------------------------------------------------------------------------
# the served cluster (parent process)


class Cluster:
    """One sim-backed cluster: Kafka + S3 + framed etcd on real ports.

    ``server_kind`` selects the serving stack — ``"async"`` (the shared
    core) or ``"legacy"`` (the retired thread-of-control-per-connection
    servers) — with identical protocol bytes either way; the A/B is what
    the determinism gate diffs. The internal telemetry registry is
    always on (it is the SLO source); ``telemetry`` adds nothing to any
    report."""

    def __init__(self, server_kind: str = "async",
                 kafka_clock=None, s3_clock=None, telemetry: bool = True,
                 kafka_advertised=None):
        assert server_kind in ("async", "legacy"), server_kind
        self.kind = server_kind
        self.registry = Registry()
        # the determinism gate runs with telemetry off to prove no
        # report byte depends on it; the full rig always instruments
        self.telemetry = (
            Telemetry(registry=self.registry) if telemetry else None
        )
        self.kafka_clock = kafka_clock
        self.s3_clock = s3_clock
        # determinism legs pin the advertised address so the ephemeral
        # bound port cannot leak into transcript hashes
        self.kafka_advertised = kafka_advertised
        self.kafka = None
        self.s3 = None
        self.etcd = None
        self._tasks: List[asyncio.Task] = []
        self.addrs: Dict[str, Tuple[str, int]] = {}

    async def start(self) -> Dict[str, Tuple[str, int]]:
        from ..etcd.service import EtcdService
        from ..kafka import wire as kwire
        from ..real import etcd as retcd
        from ..s3 import wire as s3wire

        loop = asyncio.get_running_loop()
        if self.kind == "async":
            self.kafka = kwire.WireServer(
                telemetry=self.telemetry, clock_ms=self.kafka_clock,
                advertised=self.kafka_advertised,
            )
            self.s3 = s3wire.WireServer(
                telemetry=self.telemetry, clock_ms=self.s3_clock
            )
            self.etcd = retcd.Server(
                EtcdService(), telemetry=self.telemetry
            )
        else:
            self.kafka = kwire.LegacyWireServer(
                telemetry=self.telemetry, clock_ms=self.kafka_clock,
                advertised=self.kafka_advertised,
            )
            self.s3 = s3wire.LegacyWireServer(
                telemetry=self.telemetry, clock_ms=self.s3_clock
            )
            self.etcd = retcd.LegacyServer(
                EtcdService(), telemetry=self.telemetry
            )
        for name, srv in (("kafka", self.kafka), ("s3", self.s3),
                          ("etcd", self.etcd)):
            self._tasks.append(loop.create_task(srv.serve(("127.0.0.1", 0))))
        while not all(
            getattr(s, "bound_addr", None)
            for s in (self.kafka, self.s3, self.etcd)
        ):
            await asyncio.sleep(0.01)
        # live transcripts for the replay gate
        self.kafka.wire.recorder = []
        self.s3.rest.recorder = []
        self.addrs = {
            "kafka": tuple(self.kafka.bound_addr),
            "s3": tuple(self.s3.bound_addr),
            "etcd": tuple(self.etcd.bound_addr),
        }
        return self.addrs

    async def stop(self) -> None:
        for srv in (self.kafka, self.s3, self.etcd):
            close = getattr(srv, "close", None)
            if close is not None:
                close()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass

    # -- gray failure -------------------------------------------------------

    def inject_partition(self, duration: float, parity: int) -> int:
        """Asymmetric partition: the core stops reading the Kafka
        connections whose id matches ``parity`` (mod 2) — their inbound
        traffic is blackholed while the server's outbound half stays
        live — for ``duration`` seconds."""
        core = getattr(self.kafka, "_core", None)
        if core is None:  # legacy stack has no core — no injection seam
            return 0
        return core.inject_read_stall(
            duration, match=lambda c: c.id % 2 == parity % 2
        )

    def set_fsync_stall(self, seconds: float) -> None:
        """Fsync stall under S3 multipart: UploadPart and
        CompleteMultipartUpload responses are withheld ``seconds``
        before flushing (0 clears). Core stack only."""
        adapter = getattr(self.s3, "adapter", None)
        if adapter is None:
            return
        if seconds <= 0:
            adapter.stall_hook = None
            return
        adapter.stall_hook = (
            lambda req: seconds
            if ("uploadId" in req.query
                and req.method in ("PUT", "POST"))
            else 0.0
        )

    # -- replay gates -------------------------------------------------------

    def replay_kafka(self) -> Tuple[int, bool]:
        """Re-feed the recorded (frame, clock) transcript through a
        FRESH broker: every response byte must reproduce."""
        from ..kafka.broker import Broker
        from ..kafka.wire import KafkaWire

        transcript = self.kafka.wire.recorder or []
        feed = [clk for _req, clk, _rsp in transcript]
        replay = KafkaWire(
            Broker(), clock_ms=lambda: feed.pop(0),
            advertised=self.kafka.wire.advertised,
        )
        ok = True
        for req, _clk, rsp in transcript:
            try:
                got = replay.handle_frame(req)
            except Exception:  # noqa: BLE001 — divergence is the verdict
                got = None
                ok = False
            if got != rsp:
                ok = False
        return len(transcript), ok

    def replay_s3(self) -> Tuple[int, bool]:
        """Re-dispatch the recorded S3 transcript through a FRESH
        service with the recorded clock feed: (status, body, headers)
        must reproduce exactly."""
        from ..s3.wire import S3Rest

        transcript = self.s3.rest.recorder or []
        feed = [clk for _req, clk, _rsp in transcript]
        replay = S3Rest(clock_ms=lambda: feed.pop(0))
        ok = True
        for req, _clk, (status, body, headers) in transcript:
            try:
                got = replay.handle(req)
            except Exception:  # noqa: BLE001
                got = None
                ok = False
            if got != (status, body, headers):
                ok = False
        return len(transcript), ok

    # -- the SLO report -----------------------------------------------------

    def slo_report(self, elapsed_s: float) -> dict:
        """p50/p99 + throughput per api/op/method from the server-side
        histograms, plus the core's ``serve_*`` lifecycle counters."""
        out: Dict[str, dict] = {}
        for hist_name, label in (
            ("kafka_api_seconds", "api"),
            ("s3_api_seconds", "method"),
            ("etcd_api_seconds", "op"),
        ):
            hist = self.registry.metric(hist_name)
            if hist is None:
                continue
            legs = {}
            for labelvals, row in hist.series():
                count = int(sum(row[:-1]))
                legs["/".join(labelvals)] = {
                    "count": count,
                    "p50_ms": _quantile_ms(hist.buckets, row, 0.50),
                    "p99_ms": _quantile_ms(hist.buckets, row, 0.99),
                    "rps": round(count / elapsed_s, 2) if elapsed_s else 0.0,
                }
            out[hist_name] = legs
        serve = {}
        for name in (
            "serve_connections_total", "serve_frames_total",
            "serve_bytes_in_total", "serve_bytes_out_total",
            "serve_backpressure_pauses_total",
            "serve_slow_client_drops_total", "serve_chaos_stalls_total",
        ):
            metric = self.registry.metric(name)
            if metric is None:
                continue
            serve[name] = {
                "/".join(k): int(v) for k, v in metric.series()
            }
        out["serve"] = serve
        return out


def _quantile_ms(buckets, row, q: float) -> float:
    """Quantile estimate (ms) from one histogram row by linear
    interpolation inside the landing bucket."""
    counts = row[:-1]  # per-slot counts + the +Inf slot
    total = sum(counts)
    if total == 0:
        return 0.0
    target = q * total
    cum = 0.0
    lo = 0.0
    for i, c in enumerate(counts):
        hi = buckets[i] if i < len(buckets) else buckets[-1] * 2
        if cum + c >= target and c > 0:
            frac = (target - cum) / c
            return round((lo + (hi - lo) * frac) * 1000.0, 3)
        cum += c
        lo = hi
    return round(lo * 1000.0, 3)


# ---------------------------------------------------------------------------
# worker processes: hundreds of asyncio clients each


class _HttpClient:
    """Minimal keep-alive HTTP/1.1 client for the S3 REST wire."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self.reader = None
        self.writer = None

    async def connect(self) -> None:
        self.reader, self.writer = await asyncio.open_connection(
            self.host, self.port
        )

    async def request(self, method: str, target: str, body: bytes = b"",
                      headers: Optional[Dict[str, str]] = None):
        lines = [f"{method} {target} HTTP/1.1",
                 f"Host: {self.host}:{self.port}",
                 f"Content-Length: {len(body)}"]
        for k, v in (headers or {}).items():
            lines.append(f"{k}: {v}")
        self.writer.write(
            ("\r\n".join(lines) + "\r\n\r\n").encode() + body
        )
        await self.writer.drain()
        head = await self.reader.readuntil(b"\r\n\r\n")
        head_lines = head.decode("latin-1").split("\r\n")
        status = int(head_lines[0].split(" ", 2)[1])
        rsp_headers = {}
        for line in head_lines[1:]:
            if ":" in line:
                k, _, v = line.partition(":")
                rsp_headers[k.strip().lower()] = v.strip()
        length = int(rsp_headers.get("content-length", "0"))
        rsp_body = b""
        if length and method != "HEAD":
            rsp_body = await self.reader.readexactly(length)
        return status, rsp_body, rsp_headers

    def close(self) -> None:
        if self.writer is not None:
            try:
                self.writer.close()
            except Exception:  # pragma: no cover
                pass


async def _kafka_producer(cid, addr, cfg, rec, stats) -> None:
    from ..kafka.probe import ProbeClient, RealTransport

    c = ProbeClient(await RealTransport.connect(addr))
    part = cid % cfg["partitions"]
    deadline = cfg["t0"] + cfg["run_secs"]
    gap = cfg["run_secs"] / max(1, cfg["kafka_records"])
    try:
        for r in range(cfg["kafka_records"]):
            seq = (cid * cfg["kafka_records"] + r) & _I31
            opid = rec.invoke(client=cid, op=OP_PRODUCE, key=part, inp=seq)
            err, off = await c.produce(
                TOPIC, part,
                [(int(_walltime.time() * 1000), b"p%d" % cid,
                  b"r%d" % seq)],
            )
            if err:
                stats["errors"] += 1
                continue  # open op: may or may not have happened
            rec.complete(client=cid, opid=opid, out=(off + 1) & _I31)
            stats["kafka_ops"] += 1
            now = _walltime.time()
            if now < deadline:
                await asyncio.sleep(min(gap, deadline - now))
    finally:
        c.close()


async def _kafka_consumer(cid, addr, cfg, rec, stats, group: str,
                          late: bool) -> None:
    from ..kafka import wire as kwire
    from ..kafka.probe import ProbeClient, ProbeError, RealTransport

    if late:
        # joins mid-run — inside the partition window, so the rebalance
        # happens UNDER the asymmetric partition
        await asyncio.sleep(cfg["run_secs"] * cfg["chaos_at"])
    c = ProbeClient(await RealTransport.connect(addr))
    deadline = cfg["t0"] + cfg["run_secs"]
    try:
        member, gen, assignment = await c.group_session(group, [TOPIC])
        positions: Dict[int, int] = {}
        while _walltime.time() < deadline:
            for _topic, p in assignment:
                offset = positions.get(p, 0)
                opid = rec.invoke(client=cid, op=OP_FETCH, key=p, inp=offset)
                err, _high, rows = await c.fetch(TOPIC, p, offset)
                if err:
                    stats["errors"] += 1
                    continue
                rec.complete(client=cid, opid=opid, out=len(rows))
                stats["kafka_ops"] += 1
                if rows:
                    positions[p] = rows[-1][0] + 1
            hb = await c.heartbeat(group, gen, member)
            if hb == kwire.ERR_REBALANCE_IN_PROGRESS:
                # rejoin; `positions` is deliberately NOT pruned — a
                # partition lost and later readopted must resume at its
                # last fetched offset or LogSpec's per-(client,
                # partition) contiguity check trips
                member, gen, assignment = await c.group_session(
                    group, [TOPIC], member_id=member
                )
            elif hb != 0:
                # e.g. kicked for missing heartbeats through the
                # partition window: rejoin as a fresh member
                member, gen, assignment = await c.group_session(
                    group, [TOPIC]
                )
            elif positions:
                await c.offset_commit(
                    group, gen, member,
                    [(TOPIC, p, off)
                     for p, off in sorted(positions.items())],
                )
            await asyncio.sleep(0.05)
        await c.leave_group(group, member)
    except (ProbeError, ConnectionError, asyncio.IncompleteReadError):
        stats["errors"] += 1  # e.g. stalled through the partition window
    finally:
        c.close()


async def _s3_client(cid, addr, cfg, rec, stats) -> None:
    c = _HttpClient(*addr)
    await c.connect()
    deadline = cfg["t0"] + cfg["run_secs"]
    nops = cfg["s3_ops"]
    gap = cfg["run_secs"] / max(1, nops)
    own = f"k{cid}"
    shared = f"shared{cid % cfg['s3_shared_keys']}"
    try:
        for n in range(nops):
            kind = n % 4
            use_shared = (n % 7) == 3
            keyname = shared if use_shared else own
            keyid = (cid % cfg["s3_shared_keys"]) if use_shared \
                else (cfg["s3_shared_keys"] + cid)
            if kind in (0, 2):  # put (multipart every other put)
                body = body_for(cid, n)
                fp = fingerprint(body)
                opid = rec.invoke(client=cid, op=OP_PUT, key=keyid, inp=fp)
                if kind == 2 and not use_shared:
                    ok = await _s3_multipart(c, keyname, body)
                else:
                    status, _b, _h = await c.request(
                        "PUT", f"/{BUCKET}/{keyname}", body
                    )
                    ok = status == 200
                if ok:
                    rec.complete(client=cid, opid=opid, out=fp)
                    stats["s3_ops"] += 1
                else:
                    stats["errors"] += 1
            elif kind == 1:  # get
                opid = rec.invoke(client=cid, op=OP_GET, key=keyid, inp=0)
                status, rsp_body, _h = await c.request(
                    "GET", f"/{BUCKET}/{keyname}"
                )
                if status == 200:
                    rec.complete(client=cid, opid=opid,
                                 out=fingerprint(rsp_body))
                    stats["s3_ops"] += 1
                elif status == 404:
                    rec.complete(client=cid, opid=opid, out=-1)
                    stats["s3_ops"] += 1
                else:
                    stats["errors"] += 1
            else:  # delete (own key only: shared deletes thrash GETs)
                if use_shared:
                    continue
                opid = rec.invoke(client=cid, op=OP_DEL, key=keyid, inp=0)
                status, _b, _h = await c.request(
                    "DELETE", f"/{BUCKET}/{own}"
                )
                if status in (200, 204):
                    rec.complete(client=cid, opid=opid, out=0)
                    stats["s3_ops"] += 1
                else:
                    stats["errors"] += 1
            now = _walltime.time()
            if now < deadline:
                await asyncio.sleep(min(gap, deadline - now))
    except (ConnectionError, asyncio.IncompleteReadError):
        stats["errors"] += 1
    finally:
        c.close()


async def _s3_multipart(c: _HttpClient, key: str, body: bytes) -> bool:
    """The multipart lifecycle: create → 2 parts → complete. The fsync
    stall hits exactly these requests."""
    status, rsp, _h = await c.request("POST", f"/load/{key}?uploads")
    if status != 200:
        return False
    upload_id = rsp.split(b"<UploadId>")[1].split(b"</UploadId>")[0]
    uid = upload_id.decode()
    half = len(body) // 2
    for part, chunk in ((1, body[:half]), (2, body[half:])):
        status, _b, _h = await c.request(
            "PUT", f"/load/{key}?partNumber={part}&uploadId={uid}", chunk
        )
        if status != 200:
            return False
    xml = (
        "<CompleteMultipartUpload>"
        "<Part><PartNumber>1</PartNumber></Part>"
        "<Part><PartNumber>2</PartNumber></Part>"
        "</CompleteMultipartUpload>"
    ).encode()
    status, _b, _h = await c.request(
        "POST", f"/load/{key}?uploadId={uid}", xml
    )
    return status == 200


async def _etcd_client(cid, addr, cfg, rec, stats) -> None:
    from ..real import etcd as retcd

    client = await retcd.Client.connect([f"{addr[0]}:{addr[1]}"])
    deadline = cfg["t0"] + cfg["run_secs"]
    nops = cfg["etcd_ops"]
    gap = cfg["run_secs"] / max(1, nops)
    own_key = 1_000_000 + cid
    shared_key = cid % cfg["etcd_shared_keys"]
    try:
        for n in range(nops):
            use_shared = (n % 5) == 2
            keyid = shared_key if use_shared else own_key
            wkey = b"key%d" % keyid
            if n % 2 == 0:
                val = (cid * 1000 + n) & _I31
                opid = rec.invoke(client=cid, op=OP_PUT, key=keyid, inp=val)
                await client.put(wkey, b"%d" % val)
                rec.complete(client=cid, opid=opid, out=val)
            else:
                opid = rec.invoke(client=cid, op=OP_GET, key=keyid, inp=0)
                rsp = await client.get(wkey)
                kvs = rsp.kvs()
                out = int(kvs[0].value) & _I31 if kvs else -1
                rec.complete(client=cid, opid=opid, out=out)
            stats["etcd_ops"] += 1
            now = _walltime.time()
            if now < deadline:
                await asyncio.sleep(min(gap, deadline - now))
    except Exception:  # noqa: BLE001 — a dropped client is load, not a bug
        stats["errors"] += 1


async def _worker_async(widx: int, cfg: dict, addrs: dict,
                        out: dict) -> None:
    from ..oracle.history import HostRecorder

    clock = _walltime.time_ns
    recs = {w: HostRecorder(clock=clock) for w in ("kafka", "s3", "etcd")}
    stats = {"kafka_ops": 0, "s3_ops": 0, "etcd_ops": 0, "errors": 0}
    tasks = []
    loop = asyncio.get_running_loop()

    for role, cid in cfg["roles"]:
        if role == "kprod":
            coro = _kafka_producer(cid, addrs["kafka"], cfg,
                                   recs["kafka"], stats)
        elif role.startswith("kcons"):
            _, gidx, late = role.split(":")
            coro = _kafka_consumer(
                cid, addrs["kafka"], cfg, recs["kafka"], stats,
                group=f"{GROUP_PREFIX}-{gidx}", late=late == "1",
            )
        elif role == "s3":
            coro = _s3_client(cid, addrs["s3"], cfg, recs["s3"], stats)
        else:
            coro = _etcd_client(cid, addrs["etcd"], cfg,
                                recs["etcd"], stats)
        tasks.append(loop.create_task(coro))
        if len(tasks) % 32 == 0:
            await asyncio.sleep(0)  # stagger the connect surge

    grace = cfg["run_secs"] * 3 + 30
    done, pending = await asyncio.wait(tasks, timeout=grace)
    for t in pending:
        t.cancel()
        stats["errors"] += 1
    for t in done:
        if t.exception() is not None:
            stats["errors"] += 1

    out["rows"] = {w: list(recs[w]._rows) for w in recs}
    out["stats"] = stats
    out["open"] = {
        w: len(recs[w]._open) for w in recs
    }


def _worker_main(widx: int, cfg: dict, addrs: dict, q) -> None:
    # forked from inside the parent's running event loop: clear the
    # inherited thread-local "a loop is running" marker or asyncio.run
    # refuses to start, and drop the inherited loop object
    import asyncio.events as _ev

    _ev._set_running_loop(None)
    asyncio.set_event_loop(None)
    out: dict = {"widx": widx}
    try:
        asyncio.run(_worker_async(widx, cfg, addrs, out))
    except Exception as e:  # noqa: BLE001 — report, don't hang the rig
        out["fatal"] = repr(e)
        out.setdefault("rows", {"kafka": [], "s3": [], "etcd": []})
        out.setdefault("stats", {"kafka_ops": 0, "s3_ops": 0,
                                 "etcd_ops": 0, "errors": 1})
    q.put(out)


# ---------------------------------------------------------------------------
# history assembly + checking (parent)


def merge_history(all_rows: List[tuple], seed: int):
    """Merge per-worker HostRecorder rows — (client, code, key, val,
    opid, t_ns) — into one checkable History. Client ids are globally
    unique, so pairing is safe; rows sort by wall time (one shared
    machine clock), tie-broken deterministically."""
    import numpy as np

    rows = sorted(all_rows, key=lambda r: (r[5], r[0], r[1], r[4]))
    if not rows:
        return decode_rows(
            np.zeros((0, 5), dtype=np.int32),
            np.zeros((0,), dtype=np.int64), 0, False, seed=seed,
        )
    rec = np.asarray([r[:5] for r in rows], dtype=np.int32)
    t = np.asarray([r[5] for r in rows], dtype=np.int64)
    return decode_rows(rec, t, len(rows), False, seed=seed)


def check_wire_histories(histories: dict, max_states: int = 200_000) -> dict:
    """Run each wire's history against its sequential spec."""
    specs = {"kafka": LogSpec(), "s3": S3Spec(), "etcd": KVSpec()}
    out = {}
    for wire, hist in histories.items():
        result = check_history(hist, specs[wire], max_states=max_states)
        out[wire] = {
            "ops": len(hist.ops),
            "ok": bool(result.ok),
            "decided": bool(result.decided),
            "reason": result.reason if not result.ok else "",
        }
    return out


# ---------------------------------------------------------------------------
# the scenario driver


def plan_roles(cfg: dict) -> List[List[Tuple[str, int]]]:
    """Assign (role, client_id) pairs round-robin to workers. Client ids
    are globally unique across every wire and worker."""
    roles: List[Tuple[str, int]] = []
    cid = 0
    for _ in range(cfg["kafka_producers"]):
        roles.append(("kprod", cid)); cid += 1
    for g in range(cfg["kafka_groups"]):
        for m in range(cfg["kafka_members"]):
            late = 1 if m == cfg["kafka_members"] - 1 else 0
            roles.append((f"kcons:{g}:{late}", cid)); cid += 1
    for _ in range(cfg["s3_clients"]):
        roles.append(("s3", cid)); cid += 1
    for _ in range(cfg["etcd_clients"]):
        roles.append(("etcd", cid)); cid += 1
    per: List[List[Tuple[str, int]]] = [
        [] for _ in range(cfg["workers"])
    ]
    for i, rc in enumerate(roles):
        per[i % cfg["workers"]].append(rc)
    return per


def _chaos_child(cfg: dict, q) -> None:
    """``chaos_plan`` in a forked child: ``compile_host`` runs torch ops
    on the CPU (and imports the engine package), and torch's thread pools
    must never exist in the parent that later forks the load workers
    (fork + threads = deadlock risk)."""
    q.put(chaos_plan(cfg))


def chaos_plan(cfg: dict) -> dict:
    """Derive the gray-failure windows from a compiled FaultSpec
    schedule — the same host-fault vocabulary the sim tier uses
    (``faults.compile_host``), so window times and victims are a pure
    function of the seed."""
    from .. import faults as hfaults
    from ..engine.faults import FaultSpec

    spec = FaultSpec(
        spikes=2,
        spike_window_ns=int(cfg["run_secs"] * 1e9),
        spike_dur_lo_ns=int(cfg["run_secs"] * 0.08e9),
        spike_dur_hi_ns=int(cfg["run_secs"] * 0.2e9),
        spike_lat_lo_ns=1, spike_lat_hi_ns=2,
    )
    events = hfaults.compile_host(spec, num_nodes=2, seed=cfg["seed"])
    window = int(cfg["run_secs"] * 1e9)
    starts = sorted(
        t_ns for t_ns, _a, _v in events
    ) or [window // 3, window // 2]
    victims = [v for _t, _a, v in events] or [0, 1]
    frac = max(0.15, min(0.6, starts[0] / window))
    return {
        "partition_at": frac,
        "partition_dur": max(0.5, cfg["run_secs"] * 0.15),
        "partition_parity": victims[0] % 2,
        "fsync_at": max(0.2, min(0.7, starts[-1] / window)),
        "fsync_dur": max(0.5, cfg["run_secs"] * 0.12),
        "fsync_stall": 0.2,
        "events": len(events),
    }


DEFAULT_SCENARIO = dict(
    kafka_producers=480,
    kafka_groups=9,
    kafka_members=8,
    kafka_records=6,
    partitions=64,
    s3_clients=416,
    s3_ops=8,
    s3_shared_keys=16,
    etcd_clients=88,
    etcd_ops=8,
    etcd_shared_keys=8,
    workers=4,
    run_secs=20.0,
    seed=0,
)

SMOKE_SCENARIO = dict(
    kafka_producers=24,
    kafka_groups=2,
    kafka_members=4,
    kafka_records=4,
    partitions=8,
    s3_clients=20,
    s3_ops=6,
    s3_shared_keys=4,
    etcd_clients=12,
    etcd_ops=6,
    etcd_shared_keys=4,
    workers=2,
    run_secs=4.0,
    seed=0,
)


def total_clients(cfg: dict) -> int:
    return (cfg["kafka_producers"]
            + cfg["kafka_groups"] * cfg["kafka_members"]
            + cfg["s3_clients"] + cfg["etcd_clients"])


async def _run_load_async(cfg: dict, server_kind: str) -> dict:
    from ..kafka.probe import ProbeClient, RealTransport

    cluster = Cluster(server_kind=server_kind)
    addrs = await cluster.start()

    # topic setup before any client connects
    setup = ProbeClient(await RealTransport.connect(addrs["kafka"]))
    await setup.create_topics([(TOPIC, cfg["partitions"])])
    setup.close()
    s3setup = _HttpClient(*addrs["s3"])
    await s3setup.connect()
    await s3setup.request("PUT", f"/{BUCKET}")
    s3setup.close()

    # the chaos schedule compiles in a child process: the parent must
    # stay torch-free so forking the load workers below is safe
    ctx = mp.get_context("fork")
    q0 = ctx.Queue()
    p0 = ctx.Process(target=_chaos_child, args=(cfg, q0), daemon=True)
    p0.start()
    chaos = q0.get(timeout=300)
    p0.join(timeout=10)
    cfg = dict(cfg, t0=_walltime.time(), chaos_at=chaos["partition_at"])

    q = ctx.Queue()
    per_worker = plan_roles(cfg)
    procs = []
    for widx, roles in enumerate(per_worker):
        wcfg = dict(cfg, roles=roles)
        p = ctx.Process(
            target=_worker_main, args=(widx, wcfg, addrs, q), daemon=True
        )
        p.start()
        procs.append(p)

    # chaos scheduler + connection peak sampler in the serving loop
    peak = {"conns": 0}
    stall_counts = {"partition": 0}

    async def sampler():
        while True:
            gauge = cluster.registry.metric("serve_connections_open")
            if gauge is not None:
                open_now = int(sum(v for _k, v in gauge.series()))
                peak["conns"] = max(peak["conns"], open_now)
            await asyncio.sleep(0.05)

    async def chaos_task():
        await asyncio.sleep(cfg["run_secs"] * chaos["partition_at"])
        stall_counts["partition"] = cluster.inject_partition(
            chaos["partition_dur"], chaos["partition_parity"]
        )
        delta = cfg["run_secs"] * (chaos["fsync_at"]
                                   - chaos["partition_at"])
        await asyncio.sleep(max(0.0, delta))
        cluster.set_fsync_stall(chaos["fsync_stall"])
        await asyncio.sleep(chaos["fsync_dur"])
        cluster.set_fsync_stall(0.0)

    sam = asyncio.get_running_loop().create_task(sampler())
    cha = asyncio.get_running_loop().create_task(chaos_task())

    # collect worker results without blocking the serving loop
    results = []
    deadline = _walltime.time() + cfg["run_secs"] * 6 + 60
    while len(results) < len(procs) and _walltime.time() < deadline:
        try:
            results.append(q.get_nowait())
        except Exception:  # queue.Empty
            await asyncio.sleep(0.1)
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.terminate()
    sam.cancel()
    cha.cancel()
    elapsed = _walltime.time() - cfg["t0"]

    # merge + check histories
    merged = {w: [] for w in ("kafka", "s3", "etcd")}
    stats = {"kafka_ops": 0, "s3_ops": 0, "etcd_ops": 0, "errors": 0}
    fatals = []
    for res in results:
        for w in merged:
            merged[w].extend(res.get("rows", {}).get(w, []))
        for k in stats:
            stats[k] += res.get("stats", {}).get(k, 0)
        if res.get("fatal"):
            fatals.append(res["fatal"])
    histories = {
        w: merge_history(rows, cfg["seed"]) for w, rows in merged.items()
    }
    checks = check_wire_histories(histories)

    kafka_frames, kafka_replay_ok = cluster.replay_kafka()
    s3_frames, s3_replay_ok = cluster.replay_s3()
    slo = cluster.slo_report(elapsed)
    await cluster.stop()

    total_ops = stats["kafka_ops"] + stats["s3_ops"] + stats["etcd_ops"]
    return {
        "server": server_kind,
        "seed": cfg["seed"],
        "clients": total_clients(cfg),
        "workers": cfg["workers"],
        "elapsed_s": round(elapsed, 2),
        "total_ops": total_ops,
        "throughput_ops_s": round(total_ops / elapsed, 2) if elapsed else 0,
        "peak_open_conns": peak["conns"],
        "stats": stats,
        "missing_workers": len(procs) - len(results),
        "fatals": fatals,
        "chaos": dict(chaos, partition_stalled=stall_counts["partition"]),
        "history_checks": checks,
        "histories_ok": all(c["ok"] for c in checks.values()),
        "replay": {
            "kafka_frames": kafka_frames,
            "kafka_ok": kafka_replay_ok,
            "s3_requests": s3_frames,
            "s3_ok": s3_replay_ok,
        },
        "replay_ok": kafka_replay_ok and s3_replay_ok,
        "slo": slo,
    }


def run_load(cfg: Optional[dict] = None, server_kind: str = "async") -> dict:
    """Run the full multi-process load scenario; returns the report."""
    merged = dict(DEFAULT_SCENARIO)
    merged.update(cfg or {})
    return asyncio.run(_run_load_async(merged, server_kind))
