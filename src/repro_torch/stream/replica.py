"""WAL-shipping read replicas: horizontal read fan-out for the SM-tree.

The WAL is framed, crc'd, and replay-deterministic (DESIGN.md §10), which
is everything a follower needs: a replica restores the leader's snapshot,
then *tails* the WAL directory (shipped segments on a shared/replicated
mount), replaying every batch through the identical ``apply_mutations``
pipeline and every rebalance record with its recorded seed.  Because the
whole mutation path is bitwise-deterministic — cohort cuts, device
split/merge passes, headroom growth points — the follower publishes
epochs whose ``TreeArrays`` are **bitwise identical** to the leader's at
the same WAL sequence number.  That is verified, not assumed: the digest
exchange hashes every array of the pinned epoch on both sides.

    leader:   seq, digest = ledger_digest(eng)          # after any batch
    follower: rep.poll(); rep.verify(seq, digest)       # raises on drift

Resume is torn-tail tolerant (``stream.wal.tail_wal``): a frame the
leader is mid-append on — or that the shipping layer has only partially
delivered — parks the cursor at the last complete frame; the next poll
picks it up once whole.  Restarting a follower from the *same* snapshot
replays the same tail to the same state, so replicas are disposable.

Replicas serve reads only (their engines have no WAL of their own, and
``apply`` is never called with ``log=True``); writes belong to the
leader.  For forest serving, hand the follower's shards to
``core.distributed.place_forest`` and run ``forest_knn`` against them.

Port of ``repro/stream/replica.py``.  ``tree_digest`` hashes the same bytes
in the same order as the reference's, so the two packages' digests compare
directly: equal digests mean equal trees across backends.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time

import numpy as np

from repro_torch import obs
from repro_torch.core.smtree import ARRAY_FIELDS
from repro_torch.stream.pipeline import StreamingEngine, StreamingForest
from repro_torch.stream.wal import KIND_BATCH, WalCursor, tail_wal

__all__ = ["tree_digest", "ledger_digest", "DigestMismatch", "Replica"]


def tree_digest(tree_or_trees) -> str:
    """SHA-256 over every array (and the geometry meta) of a pinned
    epoch — one tree or a tuple/list of forest shards.  Bitwise: two
    trees digest equal iff every leaf is byte-identical."""
    trees = (tree_or_trees if isinstance(tree_or_trees, (tuple, list))
             else (tree_or_trees,))
    h = hashlib.sha256()
    for t in trees:
        h.update(repr((t.capacity, t.dim, t.metric, t.max_nodes,
                       t.min_fill)).encode())
        for name in ARRAY_FIELDS:
            a = getattr(t, name).cpu().numpy()
            h.update(name.encode())
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def ledger_digest(engine) -> tuple[int, str]:
    """Leader-side half of the digest exchange: (wal_seq, digest) of the
    currently *published* epoch.  Call between batches (an epoch-publish
    boundary); a follower that has applied through ``wal_seq`` must
    produce the same digest."""
    if engine.wal is None:
        raise ValueError("leader has no WAL — nothing to ship")
    seq = engine.wal.next_seq - 1
    with engine.epochs.reading() as pinned:
        return seq, tree_digest(pinned)


class DigestMismatch(AssertionError):
    """Follower state diverged from the leader's digest — replication bug
    or nondeterministic replay; never expected in production."""


class Replica:
    """A follower that tails a WAL directory and publishes epochs.

    ``follower`` is a ``StreamingEngine`` or ``StreamingForest`` holding
    the snapshot state (constructed with ``wal=None`` — the replica never
    appends), typically via :meth:`from_snapshot`.  ``start_seq`` is the
    WAL high-water mark baked into that snapshot (records at or below it
    are skipped).  Construction params that shape replay (``max_batch``,
    ``device_splits``/``device_merges``, ``headroom_frac``) must match the
    leader's, or replay is still *correct* but not bitwise — the digest
    exchange exists to catch exactly that.

    ``max_records_per_poll`` bounds one poll's replay work so a
    far-behind follower drains its backlog in slices instead of stalling
    its serving thread for the whole tail (reads keep landing on the
    epochs published between slices).  ``max_stall_polls`` arms the WAL
    tail's corruption diagnostic (``wal.WalTailStall``): N consecutive
    parked polls with undecodable bytes pending raises instead of
    spinning silently forever.  ``lag`` = leader's acknowledged seq minus
    applied seq — the router's staleness bound; the leader side comes
    from transport end markers (``note_leader_seq``) or, absent those,
    the highest record seq this replica has scanned.
    """

    def __init__(self, follower, wal_dir: str, *, start_seq: int = -1,
                 max_records_per_poll: int | None = None,
                 max_stall_polls: int | None = None):
        if getattr(follower, "wal", None) is not None:
            raise ValueError("replica follower must not own a WAL "
                             "(it tails the leader's)")
        self.follower = follower
        self.wal_dir = wal_dir
        self.cursor = WalCursor(seq=start_seq)
        self.max_records_per_poll = max_records_per_poll
        self.max_stall_polls = max_stall_polls
        self.leader_seq = start_seq
        self._lock = threading.Lock()     # poll() is single-flight
        self._running = False
        self._thread: threading.Thread | None = None

    # -- construction ------------------------------------------------------
    @classmethod
    def from_snapshot(cls, ckpt_dir: str, wal_dir: str, **kw) -> "Replica":
        """Restore the leader's last snapshot (no replay — the tail is
        applied incrementally by ``poll``)."""
        from repro_torch.dist.checkpoint import read_manifest
        extra = read_manifest(ckpt_dir)["extra"]
        maker = (StreamingEngine if extra["kind"] == "smtree"
                 else StreamingForest)
        follower = maker.restore(ckpt_dir, wal=None, **kw)
        return cls(follower, wal_dir, start_seq=int(extra["wal_seq"]))

    # -- state -------------------------------------------------------------
    @property
    def applied_seq(self) -> int:
        return self.cursor.seq

    @property
    def lag(self) -> int:
        """Records the leader has acknowledged that this follower has not
        yet applied (>= 0).  Exact when the transport feeds
        ``note_leader_seq``; otherwise a lower bound from the records this
        replica has itself scanned."""
        return max(0, self.leader_seq - self.cursor.seq)

    def note_leader_seq(self, seq: int) -> None:
        """Record the leader's acknowledged high-water mark (monotonic) —
        the socket transport calls this with every end marker's
        ``leader_seq``."""
        with self._lock:
            self.leader_seq = max(self.leader_seq, int(seq))

    @property
    def epochs(self):
        return self.follower.epochs

    def digest(self) -> tuple[int, str]:
        """(applied_seq, digest) of the follower's published epoch."""
        with self._lock:
            with self.follower.epochs.reading() as pinned:
                return self.cursor.seq, tree_digest(pinned)

    # -- replication -------------------------------------------------------
    def poll(self) -> int:
        """Tail once: apply the next slice of complete records (all of
        them, or at most ``max_records_per_poll``); returns how many."""
        with self._lock:
            records, cur = tail_wal(self.wal_dir, self.cursor,
                                    max_records=self.max_records_per_poll,
                                    max_stalls=self.max_stall_polls)
            n = 0
            # one replay span per non-empty poll: the mutation trace's
            # replica leg (records carry the leader-assigned seqs)
            rspan = (obs.start_span("replica.replay",
                                    first_seq=records[0].seq,
                                    n_records=len(records))
                     if records and obs.enabled() else obs.NULL_SPAN)
            for rec in records:
                if rec.kind == KIND_BATCH:
                    self.follower.apply(rec.ops.astype(np.int32), rec.xs,
                                        rec.oids, log=False)
                else:
                    # control records (rebalance / migration plan /
                    # migration step) replay through the follower's own
                    # state machine so incremental migrations interleave
                    # bitwise-identically with the batch records
                    self.follower.apply_control(rec.kind, rec.params or {})
                # advance seq per record, not per poll: a crash mid-poll
                # resumes after the last *applied* record (offset is
                # per-poll, but the seq filter makes the re-scan skip)
                self.cursor.seq = rec.seq
                n += 1
            rspan.end(last_seq=self.cursor.seq)
            # byte position + stall count from the scan, seq from the last
            # *applied* record (they differ only if apply raised mid-poll —
            # the next poll re-scans from the old offset, seq filter skips)
            self.cursor = dataclasses.replace(cur, seq=self.cursor.seq)
            self.leader_seq = max(self.leader_seq, self.cursor.seq)
            if n and obs.enabled():
                obs.counter("replica.records_applied_total").inc(n)
                obs.gauge("replica.lag").set(float(self.lag))
                obs.gauge("replica.applied_seq").set(float(self.cursor.seq))
            return n

    def run_until(self, seq: int, *, timeout: float = 30.0,
                  interval: float = 0.005) -> None:
        """Poll until the follower has applied through ``seq``."""
        deadline = time.monotonic() + timeout
        while self.cursor.seq < seq:
            if self.poll() == 0:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"replica stuck at seq {self.cursor.seq}, "
                        f"want {seq}")
                time.sleep(interval)

    def verify(self, seq: int, digest: str, *, timeout: float = 30.0) -> None:
        """Digest exchange, follower side: catch up through ``seq`` and
        compare digests; raises :class:`DigestMismatch` on divergence."""
        self.run_until(seq, timeout=timeout)
        got_seq, got = self.digest()
        if got_seq != seq or got != digest:
            exc = DigestMismatch(
                f"replica diverged at seq {got_seq} (want {seq}): "
                f"digest {got[:16]}… != leader {digest[:16]}…")
            obs.record_fault("replica.digest_mismatch", exc,
                             applied_seq=got_seq, want_seq=seq)
            raise exc
        if obs.enabled():
            obs.counter("replica.digest_verifies_total").inc()

    # -- background tailing ------------------------------------------------
    def start(self, *, interval: float = 0.01) -> "Replica":
        """Tail continuously on a daemon thread until ``stop()``."""
        if self._running:
            return self
        self._running = True

        def loop():
            while self._running:
                if self.poll() == 0:
                    time.sleep(interval)

        self._thread = threading.Thread(target=loop, name="replica-tail",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def __enter__(self) -> "Replica":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
