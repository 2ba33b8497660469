"""Append-only write-ahead log for SM-tree mutation streams.

Every mutation batch the stream batcher applies is first framed into the
active segment file, so any tree state is reproducible as *last snapshot +
WAL tail replay* (repro.stream.pipeline) — the same bitwise-deterministic
kill/resume contract the training checkpoints carry (DESIGN.md §7/§10).

Layout (one directory per log):

    <dir>/manifest.json           strict JSON: sealed segments + next_seq
    <dir>/segment_00000000.wal    framed records, append-only
    <dir>/segment_00000001.wal    ...

Record framing (little-endian):

    u32   header length H
    H     bytes of strict-JSON header
          {"kind": "batch"|"rebalance", "seq": n, ...payload geometry...}
    P     payload bytes (ops int8 · oids int32 · xs f32, in that order;
          empty for control records), crc32 recorded in the header

The manifest is rewritten atomically (tmp-then-rename) when a segment
seals; the active segment is recovered by scanning on open.  A torn tail
record in the *active* segment (crash mid-append) terminates replay
cleanly — exactly the batch that never acknowledged — while corruption in
a sealed segment raises.

Port of ``repro/stream/wal.py`` in the same byte format: a log written by
either package replays in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import threading
import zlib
from typing import Any, Iterator

import numpy as np

from repro_torch import obs

_MANIFEST = "manifest.json"
_SEG_PREFIX = "segment_"
_SEG_SUFFIX = ".wal"
_LEN = struct.Struct("<I")

KIND_BATCH = "batch"
KIND_REBALANCE = "rebalance"
# Incremental-rebalancing control records (DESIGN.md §16).  A plan record
# carries the full deterministic migration schedule; each step record marks
# exactly where in the mutation order one bounded move executed.  Both are
# params-only control frames, so the framing/crc machinery below needs no
# special case for them.
KIND_MIGRATION_PLAN = "migration_plan"
KIND_MIGRATION_STEP = "migration_step"


class FencedOut(RuntimeError):
    """A deposed leader tried to append: its fencing token is stale (a
    newer leader holds the lease — stream/lease.py).  The append never
    reached the log, so the write was never acknowledged and is cleanly
    the *client's* to retry against the new leader."""


class WalTailStall(RuntimeError):
    """A follower's tail poll has made no progress for ``max_stalls``
    consecutive polls while unread bytes sit past its cursor — a truly
    corrupt segment (planted mid-segment corruption, a mis-shipped
    chunk), not the benign torn tail of a leader mid-append, which the
    next completed append always clears."""


@dataclasses.dataclass
class WalRecord:
    kind: str
    seq: int
    ops: np.ndarray | None = None      # [n] int8  (batch records)
    oids: np.ndarray | None = None     # [n] int32
    xs: np.ndarray | None = None       # [n, dim] f32
    params: dict | None = None         # control records (rebalance)


def _segment_name(index: int) -> str:
    return f"{_SEG_PREFIX}{index:08d}{_SEG_SUFFIX}"


def _segment_index(name: str) -> int:
    return int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])


def _encode(record: WalRecord) -> bytes:
    header: dict[str, Any] = {"kind": record.kind, "seq": record.seq}
    payload = b""
    if record.kind == KIND_BATCH:
        ops = np.ascontiguousarray(record.ops, np.int8)
        oids = np.ascontiguousarray(record.oids, np.int32)
        xs = np.ascontiguousarray(record.xs, np.float32)
        assert ops.shape == oids.shape == xs.shape[:1], \
            (ops.shape, oids.shape, xs.shape)
        payload = ops.tobytes() + oids.tobytes() + xs.tobytes()
        header["n"] = int(ops.shape[0])
        header["dim"] = int(xs.shape[1])
    else:
        header["params"] = record.params or {}
    header["crc"] = zlib.crc32(payload)
    hb = json.dumps(header, sort_keys=True, allow_nan=False).encode()
    return _LEN.pack(len(hb)) + hb + payload


def _decode_header(header: dict) -> tuple[int, WalRecord | None]:
    """(payload length, partially-built record)."""
    if header["kind"] == KIND_BATCH:
        n, dim = int(header["n"]), int(header["dim"])
        return n * (1 + 4 + 4 * dim), WalRecord(KIND_BATCH, int(header["seq"]))
    return 0, WalRecord(header["kind"], int(header["seq"]),
                        params=header.get("params", {}))


def _scan_segment(path: str, *, sealed: bool, start: int = 0,
                  max_records: int | None = None):
    """(records, valid_byte_length) of one segment, scanning from byte
    ``start`` (which must sit on a frame boundary — e.g. a prior scan's
    returned length).  A truncated/corrupt tail frame is tolerated (scan
    stops, its bytes excluded from valid_byte_length) only when ``sealed``
    is False.  ``max_records`` stops the scan cleanly after that many
    records, with the returned length on the frame boundary — a bounded
    follower poll resumes exactly there."""
    with open(path, "rb") as f:
        data = f.read()
    off, total = start, len(data)
    records: list[WalRecord] = []

    def torn(msg: str):
        if sealed:
            raise ValueError(f"corrupt sealed WAL segment {path}: {msg}")

    while off < total:
        if max_records is not None and len(records) >= max_records:
            break
        if off + _LEN.size > total:
            torn("truncated length prefix")
            break
        (hlen,) = _LEN.unpack_from(data, off)
        if off + _LEN.size + hlen > total:
            torn("truncated header")
            break
        try:
            header = json.loads(data[off + _LEN.size:off + _LEN.size + hlen])
            plen, rec = _decode_header(header)
        except (ValueError, KeyError):
            torn("unparseable header")
            break
        body_off = off + _LEN.size + hlen
        if body_off + plen > total:
            torn("truncated payload")
            break
        payload = data[body_off:body_off + plen]
        if zlib.crc32(payload) != header.get("crc"):
            torn("payload crc mismatch")
            break
        if rec.kind == KIND_BATCH:
            n, dim = int(header["n"]), int(header["dim"])
            rec.ops = np.frombuffer(payload, np.int8, n, 0).copy()
            rec.oids = np.frombuffer(payload, np.int32, n, n).copy()
            rec.xs = np.frombuffer(payload, np.float32, n * dim,
                                   n * 5).reshape(n, dim).copy()
        records.append(rec)
        off = body_off + plen
    return records, off


def _read_segment(path: str, *, sealed: bool) -> Iterator[WalRecord]:
    yield from _scan_segment(path, sealed=sealed)[0]


def _scan_dir(directory: str) -> list[str]:
    if not os.path.isdir(directory):
        return []
    return sorted(n for n in os.listdir(directory)
                  if n.startswith(_SEG_PREFIX) and n.endswith(_SEG_SUFFIX))


def iter_wal(directory: str, after_seq: int = -1) -> Iterator[WalRecord]:
    """Replay records with seq > ``after_seq`` in order, read-only.

    Safe to call while another process/handle appends: sealed segments are
    immutable and the active segment tolerates a torn tail."""
    names = _scan_dir(directory)
    sealed_names = set()
    mpath = os.path.join(directory, _MANIFEST)
    if os.path.exists(mpath):
        with open(mpath) as f:
            sealed_names = {s["name"] for s in json.load(f)["segments"]}
    for i, name in enumerate(names):
        sealed = name in sealed_names or i < len(names) - 1
        for rec in _read_segment(os.path.join(directory, name),
                                 sealed=sealed):
            if rec.seq > after_seq:
                yield rec


@dataclasses.dataclass
class WalCursor:
    """Resumable position of a WAL follower (stream/replica.py).

    ``segment``/``offset`` name the next unread byte; ``seq`` is the last
    record applied (records at or below it are skipped on overlap, so a
    cursor restored from a snapshot's ``wal_seq`` with segment/offset 0
    fast-forwards correctly).  The offset always lands on a frame
    boundary: a torn tail frame in the active segment leaves the cursor
    *before* it, and the next poll re-reads from there — once the leader's
    append completes, the same bytes parse and the record flows through.

    ``stalls`` counts consecutive polls that made no progress while
    unparseable bytes sat past the offset — the health signal that
    separates a benign mid-append torn tail (cleared by the very next
    completed append) from a truly corrupt segment (grows forever;
    ``tail_wal(max_stalls=N)`` turns it into a ``WalTailStall``).
    """
    seq: int = -1
    segment: int = 0
    offset: int = 0
    stalls: int = 0


def tail_wal(directory: str, cursor: WalCursor, *,
             max_records: int | None = None,
             max_stalls: int | None = None
             ) -> tuple[list[WalRecord], WalCursor]:
    """One follower poll: complete records past ``cursor``, plus the
    advanced cursor.  Safe to call while the leader appends — sealed
    segments are immutable, and the active segment's torn tail (a frame
    mid-append, or mid-shipment on a lagging mount) terminates the poll
    cleanly at the last complete frame.  Sealed segments wholly below the
    cursor's seq are skipped without reading their frames.

    ``max_records`` bounds how many records one poll scans (a far-behind
    follower drains its backlog across many bounded polls instead of
    stalling its serving thread for all of it); the cursor lands on the
    frame boundary after the last scanned record.  ``max_stalls`` raises
    ``WalTailStall`` once that many consecutive polls parked on the same
    offset with undecodable bytes beyond it — park-forever is the right
    behaviour for a leader mid-append, and the wrong one for a corrupt
    segment; the counter tells them apart."""
    names = _scan_dir(directory)
    cur = dataclasses.replace(cursor)
    out: list[WalRecord] = []
    sealed_meta: dict[str, dict] = {}
    mpath = os.path.join(directory, _MANIFEST)
    if os.path.exists(mpath):
        with open(mpath) as f:
            sealed_meta = {s["name"]: s for s in json.load(f)["segments"]}
    budget = max_records
    pending_bytes = 0
    for i, name in enumerate(names):
        idx = _segment_index(name)
        if idx < cur.segment:
            continue
        if budget is not None and budget <= 0:
            break
        path = os.path.join(directory, name)
        sealed = name in sealed_meta or i < len(names) - 1
        start = cur.offset if idx == cur.segment else 0
        entry = sealed_meta.get(name)
        if (sealed and start == 0 and entry is not None
                and entry.get("last_seq") is not None
                and entry["last_seq"] <= cur.seq):
            # snapshot fast-forward: this whole segment predates the cursor
            cur.segment, cur.offset = idx, os.path.getsize(path)
            continue
        records, end = _scan_segment(path, sealed=sealed, start=start,
                                     max_records=budget)
        if budget is not None:
            budget -= len(records)
        for rec in records:
            if rec.seq > cur.seq:
                out.append(rec)
                cur.seq = rec.seq
        cur.segment, cur.offset = idx, end
        if not sealed:
            # bytes past the parse point: a torn tail (benign, mid-append)
            # or corruption (permanent) — the stall counter decides which
            if budget is None or budget > 0:
                try:
                    pending_bytes = max(0, os.path.getsize(path) - end)
                except OSError:
                    pending_bytes = 0
            break   # the active segment is always the last one scanned
    progressed = (bool(out)
                  or (cur.segment, cur.offset) != (cursor.segment,
                                                   cursor.offset))
    if progressed or pending_bytes == 0:
        cur.stalls = 0
    else:
        cur.stalls = cursor.stalls + 1
        if max_stalls is not None and cur.stalls >= max_stalls:
            exc = WalTailStall(
                f"WAL tail parked at segment {cur.segment} offset "
                f"{cur.offset} for {cur.stalls} consecutive polls with "
                f"{pending_bytes} undecodable bytes beyond it — corrupt "
                f"segment in {directory!r}? (a leader mid-append clears "
                "in one append's time)")
            obs.record_fault("wal.tail_stall", exc, segment=cur.segment,
                             offset=cur.offset, stalls=cur.stalls)
            raise exc
    return out, cur


class WriteAheadLog:
    """Appender with segment rotation; one writer *process* per directory
    (appends are thread-safe within it).

    ``sync=True`` fsyncs the segment after every append (durability across
    power loss; cost measured in benchmarks/bench_stream.py).

    ``group_commit=True`` (with ``sync``) coalesces concurrent appends
    into one fsync: each appender writes + flushes its frame under the
    write lock, then joins a commit round — the first thread through
    becomes the *leader* and fsyncs once for every frame written so far;
    followers that arrive while the leader is in ``fsync`` find their
    frame already covered and return without touching the disk.  The
    durability contract is unchanged (an acknowledged append is on stable
    storage before ``append_*`` returns); only the fsync *count* drops —
    from one per append to one per concurrent burst, which closes most of
    the ~14x gap between ``sync`` and buffered appends under multi-writer
    load (the ``wal_group_fsync_*`` rows in benchmarks/bench_stream.py).
    Single-threaded callers see plain per-append fsync behaviour.

    ``fence`` (settable post-construction too — failover attaches it at
    promotion, stream/lease.py) is a zero-arg callable run under the
    append lock before every frame write; it raises ``FencedOut`` when
    this writer's lease/fencing token is stale.  A fenced append touches
    neither the log nor ``next_seq``, so a deposed leader can never
    acknowledge — or half-frame — a write the new leader won't have."""

    def __init__(self, directory: str, *, segment_max_records: int = 1024,
                 sync: bool = False, group_commit: bool = False,
                 fence=None):
        self.directory = directory
        self.segment_max_records = int(segment_max_records)
        self.sync = sync
        self.fence = fence
        self.group_commit = bool(group_commit)
        os.makedirs(directory, exist_ok=True)
        self._file = None
        # _lock serializes frame writes + bookkeeping; _commit_lock elects
        # the group-commit leader.  Lock order: _commit_lock -> _lock.
        self._lock = threading.Lock()
        self._commit_lock = threading.Lock()
        self._appended = 0      # frames written + flushed (all segments)
        self._synced = 0        # frames covered by an fsync
        self._recover()

    # -- recovery / bookkeeping ------------------------------------------
    def _recover(self) -> None:
        names = _scan_dir(self.directory)
        self.next_seq = 0
        self._active_records = 0
        self._sealed: list[dict] = []   # manifest entries, kept incrementally
        self._dir_dirty = True          # directory entry not yet fsync'd
        if names:
            self._active_index = _segment_index(names[-1])
            for i, name in enumerate(names):
                path = os.path.join(self.directory, name)
                sealed = i < len(names) - 1
                records, valid_len = _scan_segment(path, sealed=sealed)
                for rec in records:
                    self.next_seq = max(self.next_seq, rec.seq + 1)
                if sealed:
                    self._sealed.append(self._manifest_entry(name, records))
                else:
                    self._active_records = len(records)
                    if valid_len < os.path.getsize(path):
                        # torn tail from a crash mid-append: truncate it so
                        # post-recovery appends land after the last complete
                        # record instead of behind unreadable garbage (which
                        # replay would silently stop at)
                        with open(path, "r+b") as f:
                            f.truncate(valid_len)
        else:
            self._active_index = 0

    @staticmethod
    def _manifest_entry(name: str, records: list[WalRecord]) -> dict:
        return {"name": name,
                "first_seq": records[0].seq if records else None,
                "last_seq": records[-1].seq if records else None,
                "records": len(records)}

    def _active_path(self) -> str:
        return os.path.join(self.directory, _segment_name(self._active_index))

    def _ensure_open(self):
        if self._file is None:
            self._file = open(self._active_path(), "ab")
            self._dir_dirty = True
        return self._file

    def _write_manifest(self) -> None:
        doc = {"version": 1, "segments": self._sealed,
               "next_seq": self.next_seq}
        tmp = os.path.join(self.directory, f".tmp-{_MANIFEST}.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True, allow_nan=False)
            f.write("\n")
            if self.sync:
                f.flush()
                os.fsync(f.fileno())
        os.rename(tmp, os.path.join(self.directory, _MANIFEST))
        if self.sync:
            from repro_torch.dist.checkpoint import fsync_directory
            fsync_directory(self.directory)

    def _rotate_if_full(self) -> None:
        # caller holds self._lock
        if self._active_records < self.segment_max_records:
            return
        if self._file is not None:
            if self.sync:
                # seal-time fsync: under group commit a frame flushed after
                # the last leader's snapshot may not be covered yet, and
                # its writer's own commit round would find the segment
                # already closed — every sealed segment must be durable
                self._file.flush()
                os.fsync(self._file.fileno())
                self._synced = self._appended
            self._file.close()
            self._file = None
        name = _segment_name(self._active_index)
        records, _ = _scan_segment(os.path.join(self.directory, name),
                                   sealed=True)
        self._sealed.append(self._manifest_entry(name, records))
        self._active_index += 1
        self._active_records = 0
        self._write_manifest()

    # -- appends ----------------------------------------------------------
    def _append(self, rec: WalRecord) -> int:
        with self._lock:
            if self.fence is not None:
                try:
                    self.fence()        # FencedOut before any byte lands
                except FencedOut as exc:
                    # flight-recorder dump: a deposed leader just tried to
                    # write — the postmortem wants the ring *now*
                    obs.record_fault("wal.fenced_out", exc,
                                     next_seq=self.next_seq,
                                     directory=self.directory)
                    raise
            rec.seq = self.next_seq     # seq assignment must be atomic
            f = self._ensure_open()     # with the frame write
            buf = _encode(rec)
            f.write(buf)
            f.flush()
            self.next_seq = rec.seq + 1
            self._active_records += 1
            self._appended += 1
            my = self._appended
            if obs.enabled():
                obs.counter("wal.appends_total").inc()
                obs.counter("wal.bytes_total").inc(len(buf))
                obs.gauge("wal.next_seq").set(self.next_seq)
            if self.sync and not self.group_commit:
                os.fsync(f.fileno())
                if obs.enabled():
                    obs.counter("wal.fsyncs_total").inc()
                self._synced = my
                if self._dir_dirty:
                    # a freshly created segment file's *directory entry*
                    # must be durable too, or power loss drops the whole
                    # segment even though its records were fsync'd (same
                    # rule as the checkpoint commit, DESIGN.md §9)
                    from repro_torch.dist.checkpoint import fsync_directory
                    fsync_directory(self.directory)
                    self._dir_dirty = False
        if self.sync and self.group_commit:
            self._group_fsync(my)
        with self._lock:
            self._rotate_if_full()
        return rec.seq

    def _group_fsync(self, my: int) -> None:
        """Join a commit round covering frame number ``my``: returns only
        once that frame is on stable storage, fsyncing at most once.

        The fsync itself runs under the write lock: a concurrent append's
        trailing ``_rotate_if_full`` (which takes only ``_lock``) may
        close the segment, and an fsync on the raw fd outside the lock
        races that close (EBADF — or worse, a silently recycled fd).
        Group commit's win is the fsync *count* (followers covered by the
        leader's round return without touching the disk), not overlapping
        the disk wait with writes, so serialising the fsync against
        appends only queues the burst the leader's round already covers."""
        with self._commit_lock:
            if self._synced >= my:
                return      # a prior leader's fsync already covered us
            with self._lock:
                f = self._file
                if f is None:
                    # the segment sealed since our write; the seal-time
                    # fsync in _rotate_if_full covered it
                    return
                f.flush()   # concurrent writers' buffered frames too
                snapshot = self._appended
                os.fsync(f.fileno())
                if obs.enabled():
                    obs.counter("wal.fsyncs_total").inc()
                    obs.counter("wal.group_commit_rounds_total").inc()
                if self._dir_dirty:
                    # cleared only after the fsync succeeded — a failed
                    # fsync must not drop the directory-entry guarantee
                    from repro_torch.dist.checkpoint import fsync_directory
                    fsync_directory(self.directory)
                    self._dir_dirty = False
                # monotonic, and under _lock like every other _synced
                # write: a concurrent seal-time fsync may already have
                # advanced it past this round's snapshot
                self._synced = max(self._synced, snapshot)

    def append_batch(self, ops, xs, oids) -> int:
        """Frame one mutation batch; returns its sequence number."""
        return self._append(WalRecord(
            KIND_BATCH, self.next_seq, ops=np.asarray(ops, np.int8),
            oids=np.asarray(oids, np.int32), xs=np.asarray(xs, np.float32)))

    def append_rebalance(self, params: dict) -> int:
        """Frame a rebalance decision so tail replay re-executes it at the
        exact same point in the mutation order."""
        return self._append(WalRecord(KIND_REBALANCE, self.next_seq,
                                      params=params))

    def append_migration_plan(self, params: dict) -> int:
        """Frame a full migration schedule (seed + per-step donor/receiver/
        oid ranges) at the point in the mutation order where the planner
        fired; replay re-installs the identical plan."""
        return self._append(WalRecord(KIND_MIGRATION_PLAN, self.next_seq,
                                      params=params))

    def append_migration_step(self, params: dict) -> int:
        """Frame one executed migration step so replay re-runs the bounded
        move at the exact same interleaving point — including resuming a
        partially-executed plan after a crash."""
        return self._append(WalRecord(KIND_MIGRATION_STEP, self.next_seq,
                                      params=params))

    def replay(self, after_seq: int = -1) -> Iterator[WalRecord]:
        return iter_wal(self.directory, after_seq)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
