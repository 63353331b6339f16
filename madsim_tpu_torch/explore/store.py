"""Crash-safe shared corpus/bug store and the fleet lease protocol
(counterpart of ``madsim_tpu/explore/store.py``; pure Python, kept as
the port's own copy).

The on-disk format is the reference's byte for byte: a store that
either package writes is read by the other to the same ``merged()``
view.

This is the durable half of the fleet orchestrator: a directory that
any number of worker processes on a shared filesystem can read and
write concurrently, survive ``kill -9`` at ANY instruction, and still
merge to one byte-deterministic corpus. Two mechanisms, chosen so that
neither ever needs a lock:

**Records** are append-only, per-worker, sha-guarded JSONL. Each worker
owns exactly one log file (``log/<worker>.jsonl``) — no write ever
contends — and each line is ``{"kind", "key", "payload", "sha"}`` with
``sha`` the SHA-256 of the payload's canonical JSON bytes. Readers
verify every line: a torn/partial FINAL line (a writer killed
mid-append) is normal operating data — the valid prefix is kept and the
tail dropped; a sha mismatch or malformed interior line is QUARANTINED
(copied to ``quarantine/``, skipped, counted — never fatal). The merged
view is a pure function of the union of valid records: duplicates of one
``(kind, key)`` combine by *minimum canonical payload bytes*, so
re-running a reclaimed batch, double-running a batch whose lease was
stolen from a paused worker, or merging any partition of the work into
any number of logs all converge to the SAME bytes — worker-count- and
crash-schedule-invariant BY CONSTRUCTION.

**Leases** partition the work units. A grant is ``O_CREAT|O_EXCL`` on
``leases/unit_<n>.lease`` — POSIX guarantees exactly one winner, so a
double grant of a live lease is impossible. Liveness is the lease
file's mtime: ``renew`` bumps it with ``os.utime`` (path-based, so a
renewal after a reclaim's rename fails with ENOENT and reports the
lease LOST rather than resurrecting it). A lease whose mtime is older
than the TTL is expired: any worker may reclaim it by *renaming* it
aside (again exactly one winner) and re-granting. ``done/`` markers are
written atomically after a unit's records are durably appended; a
worker that dies mid-unit leaves no marker, so its unit is reclaimed
and re-run — to identical record bytes, which the min-combine merge
absorbs. Leases are therefore a work-partitioning *optimization*;
correctness (determinism, no lost or duplicated results in the merged
view) rests entirely on the record layer.

``telemetry`` (duck-typed ``count``, optional) counts grants, renewals,
reclaims, appends and quarantined lines — wall-clock-side only, never a
report byte.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

# record kinds the orchestrator writes; the store itself is agnostic —
# anything JSON-able dedups by (kind, key)
KIND_CAND = "cand"  # one swept candidate's summary (unit-partitioned)
KIND_BUG = "bug"  # one triaged+shrunk failure class (fingerprint-keyed)


def canonical_bytes(payload) -> bytes:
    """The byte encoding every guard and tie-break hashes/compares:
    sorted keys, no whitespace — any JSON-able payload, one byte string,
    identical across platforms and processes."""
    return json.dumps(
        payload, sort_keys=True, separators=(",", ":")
    ).encode()


def payload_sha(payload) -> str:
    return hashlib.sha256(canonical_bytes(payload)).hexdigest()


class Lease(NamedTuple):
    """A held work-unit lease (see module docstring for the protocol)."""

    unit: int
    path: str
    token: str  # random per-grant identity: survives worker-name reuse
    worker: str


class ReadStats(NamedTuple):
    """What scanning the logs saw (quarantine drills assert on these)."""

    lines: int  # valid records returned
    quarantined: int  # sha-mismatch / malformed interior lines skipped
    truncated_logs: int  # logs ending in a torn partial line


class CorpusStore:
    """One store directory; any number of concurrent worker handles.

    ``worker`` names this handle's own append log (default: a fresh
    pid+random name — two handles never share a log). ``ttl_s`` is the
    lease liveness window: a worker that neither retires its unit nor
    renews within it is presumed dead and its unit reclaimed.
    """

    def __init__(
        self,
        root: str,
        worker: Optional[str] = None,
        *,
        ttl_s: float = 30.0,
        telemetry=None,
    ):
        self.root = root
        self.worker = worker or f"w{os.getpid()}-{os.urandom(3).hex()}"
        if "/" in self.worker or self.worker.startswith("."):
            raise ValueError(f"worker name {self.worker!r} must be a filename")
        self.ttl_s = float(ttl_s)
        self.telemetry = telemetry
        for sub in ("log", "leases", "done", "quarantine"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        self._log_path = os.path.join(root, "log", f"{self.worker}.jsonl")
        self._log_f = None

    # -- record layer -------------------------------------------------------

    def append(self, kind: str, key: str, payload) -> None:
        """Append one sha-guarded record to this worker's own log and
        flush+fsync it — after this returns, the record survives
        ``kill -9`` (a kill DURING it leaves at most a torn final line,
        which readers drop)."""
        if self._log_f is None:
            self._log_f = open(self._log_path, "a")
        line = json.dumps(
            {
                "kind": kind,
                "key": key,
                "payload": payload,
                "sha": payload_sha(payload),
            },
            sort_keys=True,
        )
        self._log_f.write(line + "\n")
        self._log_f.flush()
        os.fsync(self._log_f.fileno())
        if self.telemetry is not None:
            self.telemetry.count(
                "fleet_records_appended_total",
                help="records appended to this worker's store log",
            )

    def close(self) -> None:
        if self._log_f is not None:
            self._log_f.close()
            self._log_f = None

    def _quarantine(self, log_name: str, raw_line: str, why: str) -> None:
        """Copy one bad line aside (append-only, per source log) so a
        post-mortem can inspect it; the read path just skips it."""
        qpath = os.path.join(self.root, "quarantine", log_name)
        with open(qpath, "a") as f:
            f.write(json.dumps({"why": why, "line": raw_line}) + "\n")
        if self.telemetry is not None:
            self.telemetry.count(
                "fleet_store_quarantined_total",
                help="corrupted store records quarantined (sha mismatch "
                "or malformed interior line)",
            )

    def read_records(self) -> Tuple[List[dict], ReadStats]:
        """Every valid record across every worker log (file order by
        name, line order within a file), plus what the scan saw.

        Never raises on bad data: a torn final line is dropped (the
        writer died mid-append), anything else that fails its sha or its
        JSON parse is quarantined and skipped."""
        records: List[dict] = []
        quarantined = 0
        truncated_logs = 0
        log_dir = os.path.join(self.root, "log")
        for name in sorted(os.listdir(log_dir)):
            if not name.endswith(".jsonl"):
                continue
            with open(os.path.join(log_dir, name)) as f:
                lines = f.read().split("\n")
            for i, raw in enumerate(lines):
                if not raw.strip():
                    continue
                rec = None
                try:
                    rec = json.loads(raw)
                except json.JSONDecodeError:
                    if i == len(lines) - 1:
                        # torn final line: the valid prefix stands
                        truncated_logs += 1
                        continue
                    self._quarantine(name, raw, "malformed")
                    quarantined += 1
                    continue
                if (
                    not isinstance(rec, dict)
                    or "payload" not in rec
                    or rec.get("sha") != payload_sha(rec["payload"])
                ):
                    self._quarantine(name, raw, "sha mismatch")
                    quarantined += 1
                    continue
                records.append(rec)
        return records, ReadStats(len(records), quarantined, truncated_logs)

    def merged(self) -> Dict[Tuple[str, str], dict]:
        """The deterministic merged view: ``(kind, key) -> payload``,
        duplicates combined by minimum canonical payload bytes — a pure
        function of the SET of valid records, so any partition of the
        work over any number of logs (including partial re-runs from
        reclaimed leases) merges to identical bytes."""
        out: Dict[Tuple[str, str], dict] = {}
        best: Dict[Tuple[str, str], bytes] = {}
        records, _ = self.read_records()
        for rec in records:
            k = (str(rec.get("kind")), str(rec.get("key")))
            b = canonical_bytes(rec["payload"])
            if k not in best or b < best[k]:
                best[k] = b
                out[k] = rec["payload"]
        return out

    # -- lease layer --------------------------------------------------------

    def _lease_path(self, unit: int) -> str:
        return os.path.join(self.root, "leases", f"unit_{unit:06d}.lease")

    def _done_path(self, unit: int) -> str:
        return os.path.join(self.root, "done", f"unit_{unit:06d}.done")

    def is_done(self, unit: int) -> bool:
        return os.path.exists(self._done_path(unit))

    def mark_done(self, unit: int) -> None:
        """Atomic done marker (tmp + rename): written only AFTER the
        unit's records are appended and fsynced, so a crash between the
        two re-runs the unit (harmless: identical record bytes)."""
        path = self._done_path(unit)
        tmp = f"{path}.tmp.{self.worker}"
        with open(tmp, "w") as f:
            json.dump({"unit": unit, "worker": self.worker}, f)
        os.replace(tmp, path)

    def try_lease(self, unit: int) -> Optional[Lease]:
        """One grant attempt: None when the unit is done, currently
        leased and live, or lost the O_EXCL race; a Lease on success.
        An EXPIRED lease (mtime older than ``ttl_s``) is reclaimed
        first — renamed aside (exactly one winner) — then re-granted."""
        if self.is_done(unit):
            return None
        path = self._lease_path(unit)
        try:
            age = time.time() - os.stat(path).st_mtime
        except FileNotFoundError:
            age = None
        if age is not None:
            if age <= self.ttl_s:
                return None
            # expired: exactly one renamer wins the reclaim
            stale = f"{path}.stale.{os.urandom(4).hex()}"
            try:
                os.rename(path, stale)
            except FileNotFoundError:
                return None  # someone else reclaimed (or released) first
            os.unlink(stale)
            if self.telemetry is not None:
                self.telemetry.count(
                    "fleet_lease_reclaimed_total",
                    help="expired leases reclaimed from presumed-dead "
                    "workers",
                )
        token = os.urandom(8).hex()
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return None  # lost the grant race
        with os.fdopen(fd, "w") as f:
            json.dump({"worker": self.worker, "token": token}, f)
            f.flush()
            os.fsync(f.fileno())
        if self.telemetry is not None:
            self.telemetry.count(
                "fleet_lease_granted_total", help="work-unit leases granted"
            )
        return Lease(unit, path, token, self.worker)

    def _owns(self, lease: Lease) -> bool:
        try:
            with open(lease.path) as f:
                rec = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return False
        return rec.get("token") == lease.token

    def renew(self, lease: Lease) -> bool:
        """Heartbeat: bump the lease's mtime. False = the lease was
        reclaimed out from under us (the worker was presumed dead) —
        the caller must treat the unit as no longer theirs. Path-based
        on purpose: after a reclaim's rename there is nothing at
        ``lease.path`` (or a new holder's file with a different token),
        so a zombie's renewal can never resurrect its old lease."""
        if not self._owns(lease):
            return False
        try:
            os.utime(lease.path)
        except FileNotFoundError:
            return False
        if self.telemetry is not None:
            self.telemetry.count(
                "fleet_lease_renewed_total",
                help="lease heartbeat renewals",
            )
        return True

    def release(self, lease: Lease) -> None:
        """Drop a held lease (after ``mark_done``, or on abandon). Only
        removes the file while it is still ours."""
        if self._owns(lease):
            try:
                os.unlink(lease.path)
            except FileNotFoundError:
                pass

    def next_lease(self, units: int) -> Optional[Lease]:
        """Scan units in order and grant the first available one; None
        when every unit is done or live-leased by someone else."""
        for unit in range(units):
            lease = self.try_lease(unit)
            if lease is not None:
                return lease
        return None

    def all_done(self, units: int) -> bool:
        return all(self.is_done(u) for u in range(units))
