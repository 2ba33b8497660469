"""WAL segment shipping over a socket: the replica transport.

A ``WalShipServer`` sits next to the leader's WAL directory and serves its
bytes; a ``WalShipClient`` keeps a **mirror** WAL directory on the follower
host and pulls whatever it is missing.  The mirror is byte-identical to the
leader's log, so everything downstream — ``tail_wal``'s torn-tail-tolerant
cursor, ``Replica``'s seq-deduped replay, the digest exchange, and (on
failover, ``stream.lease``) re-opening the mirror as the *new authoritative
WAL* — reuses the existing machinery unchanged.

Port of ``repro/stream/transport.py``.  Wire protocol (little-endian, one
length-framed message at a time), the reference's:

    u32   header length H
    H     strict-JSON header {"kind": ..., "len": n, "crc": crc32(body)}
    n     body bytes

  * client -> server  ``pull``  {segment, offset}: resume point, exactly a
    ``WalCursor``'s byte position (the client recomputes it from its own
    mirror via the same ``_scan_segment`` recovery scan the WAL uses).
  * server -> client  ``chunk`` {segment, offset, len, crc} + raw segment
    bytes; then ``end`` {active_segment, leader_seq, sizes} closing the
    round.  ``sizes`` maps each segment index (as a string) from the pulled
    one on to the leader's byte length of that segment when the round was
    built.  The reference's client ignores the key.
  * client -> server  ``metrics``: the reply is one ``metrics`` message
    whose body is the JSON snapshot of ``obs.export.metrics_snapshot``.

**A segment is sealed only at the leader's length.**  The mirror may move
from segment k to k+1 only once its copy of k is as long as the leader's k,
which the round's ``sizes`` say; a segment that has a successor on the
leader's disk never grows again (the WAL creates segment k+1 at the first
append after closing k), so that length is final.  The reference's client
asks only whether its copy of k *parses* as whole frames: when the chunk
that finishes k is dropped or reordered behind the first chunk of k+1, it
seals k short and rejects the missing bytes for good, and its replica
replays a log with a hole in it.  The port's client rejects that chunk of
k+1 instead, and the next round resyncs from k.  The client applies a
round's chunks only after its ``end`` marker, which carries the sizes, so
a round cut off mid-way leaves the mirror as it was.

Wire compatibility: the reference's client pulls from the port's server
(it ignores ``sizes``).  The port's client pulls from the reference's
server only within one segment: that server sends no ``sizes``, so the
client can never tell a finished segment from a dropped chunk and does not
advance; once the leader has moved on it raises ``ShipStall``.

Delivery is **idempotent by construction**: a duplicated chunk lands at an
offset the mirror already covers and is ignored; a dropped or reordered
chunk breaks the append-at-size invariant and is ignored too, after which
the next pull round resyncs from the mirror's scanned valid length.  A
*torn* chunk (the shipping layer delivered fewer bytes than the record
frame claims — injected via ``stream.faults``) is caught exactly like a
crash mid-append: the record-level crc scan parks before it and the resync
truncates it away.  Consecutive no-progress rounds are counted so a
permanently corrupt source raises a diagnostic instead of spinning.

Connection management is explicitly failure-shaped: per-connection
timeouts on both ends, and the client's background pump reconnects with
exponential backoff + seeded jitter.  Kill-and-restart of either endpoint
is supported by the real ``stop()``/``start()`` paths (the server rebinds
its port; the client resyncs from its mirror).
"""
from __future__ import annotations

import json
import os
import random
import socket
import struct
import threading
import time
import zlib

from repro_torch import obs
from repro_torch.stream.faults import FaultInjector
from repro_torch.stream.replica import Replica
from repro_torch.stream.wal import (WriteAheadLog, _MANIFEST, _scan_dir,
                                    _scan_segment, _segment_index,
                                    _segment_name)

__all__ = ["TransportError", "ShipStall", "WalShipServer", "WalShipClient",
           "ShippedReplica"]

_LEN = struct.Struct("<I")
_MAX_HEADER = 1 << 20          # sanity bound on a wire header
CHUNK_BYTES = 1 << 16


class TransportError(ConnectionError):
    """Connection-level shipping failure (timeout, EOF, bad frame) — the
    retryable class: the client's pump backs off and reconnects."""


class ShipStall(RuntimeError):
    """The shipped stream stopped making progress for too many rounds
    while the leader kept advancing — a permanently corrupt mirror or a
    wedged source, not a transient fault.  Diagnostic, not retryable."""


# -- wire framing ----------------------------------------------------------

def _send_msg(sock: socket.socket, header: dict, body: bytes = b"") -> None:
    header = dict(header)
    header["len"] = len(body)
    header["crc"] = zlib.crc32(body)
    hb = json.dumps(header, sort_keys=True, allow_nan=False).encode()
    sock.sendall(_LEN.pack(len(hb)) + hb + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            part = sock.recv(n - len(buf))
        except (socket.timeout, OSError) as e:
            raise TransportError(f"recv failed: {e}") from e
        if not part:
            raise TransportError("connection closed mid-message")
        buf.extend(part)
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> tuple[dict, bytes]:
    (hlen,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if hlen > _MAX_HEADER:
        raise TransportError(f"oversized wire header ({hlen} bytes)")
    try:
        header = json.loads(_recv_exact(sock, hlen))
    except ValueError as e:
        raise TransportError(f"unparseable wire header: {e}") from e
    body = _recv_exact(sock, int(header.get("len", 0)))
    if zlib.crc32(body) != header.get("crc"):
        raise TransportError("wire body crc mismatch")
    return header, body


# -- server (leader side) --------------------------------------------------

class WalShipServer:
    """Serves a WAL directory's bytes to pulling followers.

    ``wal`` (a ``WriteAheadLog``) or ``leader_seq_fn`` supplies the
    leader's acknowledged high-water mark for the ``end`` marker —
    followers feed it to ``Replica.note_leader_seq`` so ``lag`` is exact
    rather than observed.  ``fault`` (a ``stream.faults.FaultInjector``)
    is applied to each response's message list — drop/dup/reorder/torn —
    so tests exercise the client's resync machinery deterministically."""

    def __init__(self, wal_dir: str, *, host: str = "127.0.0.1",
                 port: int = 0, wal: WriteAheadLog | None = None,
                 leader_seq_fn=None, fault: FaultInjector | None = None,
                 timeout_s: float = 5.0, chunk_bytes: int = CHUNK_BYTES,
                 max_chunks: int = 64):
        self.wal_dir = wal_dir
        self.host = host
        self._want_port = port
        self.port: int | None = None
        self.wal = wal
        self.leader_seq_fn = leader_seq_fn
        self.fault = fault
        self.timeout_s = timeout_s
        self.chunk_bytes = int(chunk_bytes)
        self.max_chunks = int(max_chunks)
        self._listener: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._running = False
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------
    @property
    def address(self) -> tuple[str, int]:
        if self.port is None:
            raise RuntimeError("server not started")
        return (self.host, self.port)

    def start(self) -> "WalShipServer":
        with self._lock:
            if self._running:
                return self
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            # restart-after-kill rebinds the port a prior incarnation chose
            ls.bind((self.host, self.port if self.port is not None
                     else self._want_port))
            ls.listen(16)
            ls.settimeout(0.2)        # accept loop polls _running
            self.port = ls.getsockname()[1]
            self._listener = ls
            self._running = True
        t = threading.Thread(target=self._accept_loop, name="walship-accept",
                             daemon=True)
        t.start()
        self._threads = [t]
        return self

    def stop(self) -> None:
        with self._lock:
            self._running = False
            ls, self._listener = self._listener, None
        if ls is not None:
            ls.close()
        for t in self._threads:
            t.join(timeout=10)
        self._threads = []

    def __enter__(self) -> "WalShipServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- serving -----------------------------------------------------------
    def _accept_loop(self) -> None:
        while self._running:
            ls = self._listener
            if ls is None:
                return
            try:
                conn, _ = ls.accept()
            except socket.timeout:
                continue
            except OSError:
                return                      # listener closed under us
            conn.settimeout(self.timeout_s)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="walship-conn", daemon=True).start()

    def _leader_seq(self) -> int:
        if self.wal is not None:
            return self.wal.next_seq - 1
        if self.leader_seq_fn is not None:
            return int(self.leader_seq_fn())
        return -1

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                while self._running:
                    try:
                        header, _ = _recv_msg(conn)
                    except TransportError:
                        return              # client went away / timed out
                    if header.get("kind") == "metrics":
                        # `/metrics` over the socket the deployment
                        # already has open: reply with the process-wide
                        # JSON snapshot and keep the connection usable
                        from repro_torch.obs.export import metrics_snapshot
                        body = json.dumps(
                            metrics_snapshot(), default=repr).encode("utf-8")
                        _send_msg(conn, {"kind": "metrics"}, body)
                        continue
                    if header.get("kind") != "pull":
                        return              # protocol violation: hang up
                    msgs = self._build_response(int(header["segment"]),
                                                int(header["offset"]))
                    if self.fault is not None:
                        msgs = self._inject(msgs)
                        self.fault.maybe_delay()
                    for h, body in msgs:
                        _send_msg(conn, h, body)
        except OSError:
            return                          # connection dropped mid-send

    def _inject(self, msgs: list) -> list:
        """Fault-inject the data chunks (never the end marker — dropping
        the round terminator models nothing the byte protocol allows, the
        connection would just desync; killing the *connection* is the
        injector's delay/drop-at-chunk level plus the kill/restart API)."""
        chunks = [m for m in msgs if m[0]["kind"] == "chunk"]
        tail = [m for m in msgs if m[0]["kind"] != "chunk"]
        chunks = self.fault.filter(chunks)
        chunks = [(h, self.fault.torn(b)) for h, b in chunks]
        return chunks + tail

    def _build_response(self, segment: int, offset: int) -> list:
        """Chunk messages covering bytes past (segment, offset), oldest
        first, then the ``end`` marker with the leader's length of every
        segment from ``segment`` on.  Reads straight off the directory so
        it serves equally with the leader process alive (in-process WAL
        handle) or dead (failover drain: a promoted follower can finish
        pulling the tail of a crashed leader's directory)."""
        msgs: list[tuple[dict, bytes]] = []
        names = _scan_dir(self.wal_dir)
        active = _segment_index(names[-1]) if names else 0
        budget = self.max_chunks
        sizes: dict[str, int] = {}
        for name in names:
            idx = _segment_index(name)
            if idx < segment:
                continue
            path = os.path.join(self.wal_dir, name)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            sizes[str(idx)] = size
            pos = offset if idx == segment else 0
            while pos < size and budget > 0:
                n = min(self.chunk_bytes, size - pos)
                with open(path, "rb") as f:
                    f.seek(pos)
                    body = f.read(n)
                if not body:
                    break
                msgs.append(({"kind": "chunk", "segment": idx,
                              "offset": pos}, body))
                pos += len(body)
                budget -= 1
        msgs.append(({"kind": "end", "active_segment": active,
                      "leader_seq": self._leader_seq(), "sizes": sizes}, b""))
        return msgs


# -- client (follower side) ------------------------------------------------

class WalShipClient:
    """Pulls a leader's WAL into a local mirror directory.

    The mirror obeys one invariant the downstream ``tail_wal`` positional-
    sealing rule depends on: **only the newest mirror segment may be
    incomplete**, and every older one holds all of the leader's bytes.
    Chunks are accepted only when they append exactly at the mirror's
    current size; advancing to the next segment requires the current one
    to be as long as the leader's (the round's ``sizes``) and to parse
    completely (``_scan_segment`` — the same scan WAL recovery runs).
    Anything else — duplicate, gap, reordering, torn delivery — is dropped
    and repaired by the next round's resync, which recomputes the resume
    point from the mirror's scanned valid length and truncates torn bytes,
    exactly like crash recovery."""

    def __init__(self, address: tuple[str, int], mirror_dir: str, *,
                 timeout_s: float = 5.0, backoff_base_s: float = 0.02,
                 backoff_max_s: float = 2.0, seed: int = 0,
                 max_stall_rounds: int = 200):
        self.address = (address[0], int(address[1]))
        self.mirror_dir = mirror_dir
        os.makedirs(mirror_dir, exist_ok=True)
        self.timeout_s = timeout_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.max_stall_rounds = int(max_stall_rounds)
        self._jitter = random.Random(seed)
        self._sock: socket.socket | None = None
        self.leader_seq = -1          # from the last end marker
        self.active_segment = 0
        self.n_rounds = 0
        self.n_reconnects = 0
        self.n_rejected_chunks = 0
        self._stall_rounds = 0
        self._seg = 0                 # mirror append position
        self._size = 0
        self._sealed: set[int] = set()
        self._resync()
        self._running = False
        self._thread: threading.Thread | None = None

    # -- mirror bookkeeping ------------------------------------------------
    def _path(self, idx: int) -> str:
        return os.path.join(self.mirror_dir, _segment_name(idx))

    def _resync(self) -> None:
        """Recompute the append position from the mirror itself: scan the
        newest segment with the WAL's own recovery scan and truncate any
        torn tail (a killed receiver, or a torn injected chunk) so the
        next accepted chunk appends after the last *complete* frame."""
        names = _scan_dir(self.mirror_dir)
        if not names:
            self._seg, self._size = 0, 0
            return
        self._sealed = {_segment_index(n) for n in names[:-1]}
        idx = _segment_index(names[-1])
        path = self._path(idx)
        _, valid = _scan_segment(path, sealed=False)
        if valid < os.path.getsize(path):
            with open(path, "r+b") as f:
                f.truncate(valid)
        self._seg, self._size = idx, valid

    def _segment_whole(self, sizes: dict[int, int] | None) -> bool:
        """The current segment holds all of the leader's bytes (safe to
        seal): as long as the leader's copy was when the round was built,
        and parsing as frames.  Without ``sizes`` (a server that does not
        send them) the answer is no: a dropped or reordered last chunk
        would look the same as a finished segment."""
        if sizes is None or sizes.get(self._seg) != self._size:
            return False
        path = self._path(self._seg)
        if not os.path.exists(path):
            return False
        records, valid = _scan_segment(path, sealed=False)
        return (bool(records)
                and valid == os.path.getsize(path) == self._size)

    def _seal_current(self) -> None:
        """Mark the current mirror segment sealed: record it in the mirror
        manifest (entries recomputed locally — the mirror's bytes are the
        leader's bytes, so the entries match) and advance."""
        idx = self._seg
        if idx in self._sealed:
            return
        records, _ = _scan_segment(self._path(idx), sealed=True)
        entry = WriteAheadLog._manifest_entry(_segment_name(idx), records)
        self._sealed.add(idx)
        doc = {"version": 1, "next_seq": (records[-1].seq + 1 if records
                                          else 0)}
        entries = []
        mpath = os.path.join(self.mirror_dir, _MANIFEST)
        if os.path.exists(mpath):
            with open(mpath) as f:
                entries = json.load(f)["segments"]
        if entry["name"] not in {e["name"] for e in entries}:
            entries.append(entry)
        doc["segments"] = sorted(entries, key=lambda e: e["name"])
        tmp = mpath + f".tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True, allow_nan=False)
            f.write("\n")
        os.rename(tmp, mpath)

    # -- one pull round ----------------------------------------------------
    def _connect(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        try:
            s = socket.create_connection(self.address,
                                         timeout=self.timeout_s)
        except OSError as e:
            raise TransportError(f"connect to {self.address} failed: "
                                 f"{e}") from e
        s.settimeout(self.timeout_s)
        self._sock = s
        return s

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def _receive_round(self) -> tuple[list, dict]:
        """Send one pull and read its reply: (chunks, end header)."""
        sock = self._connect()
        try:
            _send_msg(sock, {"kind": "pull", "segment": self._seg,
                             "offset": self._size})
            chunks = []
            while True:
                header, body = _recv_msg(sock)
                kind = header.get("kind")
                if kind == "chunk":
                    chunks.append((int(header["segment"]),
                                   int(header["offset"]), body))
                elif kind == "end":
                    return chunks, header
                else:
                    raise TransportError(f"unknown wire message {kind!r}")
        except TransportError:
            self.close()
            raise

    def poll(self) -> int:
        """One pull round: request from the mirror's resume point, read
        every chunk and the end marker, then apply each acceptable chunk
        and process the end marker.  Returns bytes appended to the mirror.
        Raises ``TransportError`` on connection trouble (caller backs off
        and retries — the background pump does this automatically) and
        ``ShipStall`` after ``max_stall_rounds`` consecutive no-progress
        rounds while the leader is known to be ahead."""
        chunks, end = self._receive_round()
        sizes = end.get("sizes")
        if sizes is not None:
            sizes = {int(k): int(v) for k, v in sizes.items()}
        appended = 0
        for seg, off, body in chunks:
            appended += self._accept(seg, off, body, sizes)
        self.active_segment = int(end["active_segment"])
        self.leader_seq = max(self.leader_seq, int(end["leader_seq"]))
        if (self.active_segment > self._seg
                and self._segment_whole(sizes)):
            # rotation observed with no follow-on chunk yet: seal so
            # tail_wal's manifest fast-forward works
            self._seal_current()
        self.n_rounds += 1
        if obs.enabled():
            obs.counter("transport.rounds_total").inc()
            obs.counter("transport.bytes_shipped_total").inc(appended)
        if appended == 0:
            self._resync()       # repair before deciding we are stuck
            behind = self.leader_seq >= 0 and self._behind()
            self._stall_rounds = self._stall_rounds + 1 if behind else 0
            if self._stall_rounds >= self.max_stall_rounds:
                exc = ShipStall(
                    f"mirror stuck at segment {self._seg} offset "
                    f"{self._size} for {self._stall_rounds} rounds while "
                    f"leader is at seq {self.leader_seq} — corrupt "
                    "source or mirror")
                obs.record_fault("transport.ship_stall", exc,
                                 segment=self._seg, offset=self._size,
                                 rounds=self._stall_rounds,
                                 leader_seq=self.leader_seq)
                raise exc
        else:
            self._stall_rounds = 0
        return appended

    def _behind(self) -> bool:
        """Mirror's newest complete record is behind the leader's ack."""
        records, _ = _scan_segment(self._path(self._seg), sealed=False) \
            if os.path.exists(self._path(self._seg)) else ([], 0)
        last = records[-1].seq if records else -1
        return last < self.leader_seq

    def _accept(self, seg: int, off: int, body: bytes, sizes) -> int:
        """Append-at-size or reject (idempotent redelivery: duplicates and
        out-of-order chunks are dropped, resync repairs).  The first chunk
        of the next segment is taken only when the current one is whole."""
        if seg == self._seg and off == self._size:
            pass                              # in-order append
        elif seg == self._seg + 1 and off == 0 and self._segment_whole(sizes):
            self._seal_current()
            self._seg, self._size = seg, 0
        else:
            self.n_rejected_chunks += 1
            if obs.enabled():
                obs.counter("transport.rejected_chunks_total").inc()
            return 0
        with open(self._path(self._seg), "ab") as f:
            f.write(body)
        self._size += len(body)
        return len(body)

    # -- background pump ---------------------------------------------------
    def start(self, *, interval: float = 0.01) -> "WalShipClient":
        """Pull continuously on a daemon thread; reconnects with
        exponential backoff + jitter on transport errors."""
        if self._running:
            return self
        self._running = True

        def pump():
            failures = 0
            while self._running:
                try:
                    n = self.poll()
                    failures = 0
                    if n == 0:
                        time.sleep(interval)
                except TransportError:
                    failures += 1
                    delay = min(self.backoff_max_s,
                                self.backoff_base_s * (2 ** (failures - 1)))
                    # full jitter: desynchronizes a fleet of reconnecting
                    # followers hammering a restarted leader
                    time.sleep(delay * (0.5 + 0.5 * self._jitter.random()))
                    self.n_reconnects += 1
                    if obs.enabled():
                        obs.counter("transport.reconnects_total").inc()
                except ShipStall:
                    self._running = False
                    raise

        self._thread = threading.Thread(target=pump, name="walship-pump",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.close()

    def __enter__(self) -> "WalShipClient":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -- composition: socket-fed replica ---------------------------------------

class ShippedReplica:
    """A read replica fed over the socket transport: ``WalShipClient``
    pumping a local mirror + ``Replica`` tailing that mirror.  The two
    halves stay independently testable; this class only sequences them
    (ship bytes, note the leader's ack high-water, replay) and carries
    the leader-reported seq into ``Replica.lag`` for the router's
    staleness bound.  ``poll`` is single-flight: ``catch_up`` on a caller's
    thread and the background pump never share the client's socket or
    write the mirror at once."""

    def __init__(self, follower, address: tuple[str, int], mirror_dir: str,
                 *, start_seq: int = -1, seed: int = 0,
                 timeout_s: float = 5.0, max_records_per_poll: int | None = None,
                 max_stall_polls: int | None = 500):
        self.client = WalShipClient(address, mirror_dir, seed=seed,
                                    timeout_s=timeout_s)
        self.replica = Replica(follower, mirror_dir, start_seq=start_seq,
                               max_records_per_poll=max_records_per_poll,
                               max_stall_polls=max_stall_polls)
        self._poll_lock = threading.Lock()
        self._running = False
        self._thread: threading.Thread | None = None

    # -- delegation --------------------------------------------------------
    @property
    def follower(self):
        return self.replica.follower

    @property
    def epochs(self):
        return self.replica.epochs

    @property
    def applied_seq(self) -> int:
        return self.replica.applied_seq

    @property
    def lag(self) -> int:
        return self.replica.lag

    def digest(self):
        return self.replica.digest()

    def verify(self, seq: int, digest: str, *, timeout: float = 30.0):
        return self.replica.verify(seq, digest, timeout=timeout)

    # -- pumping -----------------------------------------------------------
    def poll(self) -> int:
        """Ship once, then replay once; returns records applied."""
        with self._poll_lock:
            self.client.poll()
            self.replica.note_leader_seq(self.client.leader_seq)
            return self.replica.poll()

    def catch_up(self, seq: int, *, timeout: float = 30.0,
                 interval: float = 0.002) -> None:
        """Pump until the follower has applied through ``seq`` (transport
        errors back off and retry inside the window)."""
        deadline = time.monotonic() + timeout
        failures = 0
        while self.replica.cursor.seq < seq:
            try:
                n = self.poll()
                failures = 0
            except TransportError:
                n, failures = 0, failures + 1
                time.sleep(min(0.2, 0.01 * (2 ** min(failures, 4))))
            if n == 0:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"shipped replica stuck at seq "
                        f"{self.replica.cursor.seq}, want {seq}")
                time.sleep(interval)

    def start(self, *, interval: float = 0.005) -> "ShippedReplica":
        if self._running:
            return self
        self._running = True

        def pump():
            failures = 0
            while self._running:
                try:
                    n = self.poll()
                    failures = 0
                except TransportError:
                    n, failures = 0, failures + 1
                    delay = min(self.client.backoff_max_s,
                                self.client.backoff_base_s
                                * (2 ** (failures - 1)))
                    time.sleep(delay
                               * (0.5 + 0.5 * self.client._jitter.random()))
                    self.client.n_reconnects += 1
                    if obs.enabled():
                        obs.counter("transport.reconnects_total").inc()
                if n == 0:
                    time.sleep(interval)

        self._thread = threading.Thread(target=pump, name="shipped-replica",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.client.close()

    def __enter__(self) -> "ShippedReplica":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
