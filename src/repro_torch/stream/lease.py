"""Lease-based leader election with monotonic fencing tokens.

One writer per WAL directory is the log's core invariant; this module is
how that invariant survives the writer dying.  A **lease** is a claim on
leadership with an expiry; whoever holds the unexpired lease is the
leader.  Every grant carries a **fencing token** that increases
monotonically across takeovers — the token, not the lease file's timing,
is what protects the log: the leader's ``WriteAheadLog`` runs a
:class:`FenceGuard` under its append lock, and the guard rejects the
append (``wal.FencedOut``) the moment a *higher* token exists.  A deposed
leader therefore cannot acknowledge — or even half-frame — a write after
its successor takes over, no matter how stale its own view of the clock
is.  (Expiry alone is never trusted for safety, only for liveness: an
expired-but-unclaimed lease keeps accepting appends, because loss is only
possible once a new claimant exists, and a new claimant always means a
higher token.)

The store is a single JSON file updated by compare-and-swap (an
``O_EXCL`` lockfile serializes writers across processes; tmp-then-rename
keeps readers crash-consistent) — deliberately the same durability idiom
as the WAL manifest.  Tests inject a manual clock so expiry is a
deterministic event, not a sleep.

Failover is :func:`promote`: a caught-up follower acquires the lease
(new, higher token), **drains** the shipped tail it already has (and, if
the dead leader's ship server still serves the directory, pulls the last
bytes — ``transport.WalShipServer`` reads straight off disk precisely so
a crashed leader's log remains drainable), optionally **verifies** the
digest exchange against the last acknowledged leader state, then re-opens
the mirror as its own authoritative ``WriteAheadLog`` with the new fence
attached and hands it to the follower engine.  From that point the
follower *is* the leader: ``apply(..., log=True)`` appends under the new
token, and the old leader's next append raises ``FencedOut``.

Port of ``repro/stream/lease.py`` (no tensor in it): the lease file is the
reference's JSON, byte for byte, so either package reads the other's, and
``FenceGuard`` sits on the port's ``WriteAheadLog`` fence hook.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

from repro_torch import obs
from repro_torch.stream.replica import Replica
from repro_torch.stream.wal import FencedOut, WriteAheadLog

__all__ = ["Lease", "LeaseStore", "LeaseLost", "FenceGuard", "Promotion",
           "promote"]


class LeaseLost(RuntimeError):
    """A renew/release was attempted under a token that no longer holds
    the lease — the caller has been superseded and must stop leading."""


@dataclasses.dataclass(frozen=True)
class Lease:
    """One grant: ``token`` is the fencing token (monotonic across all
    grants ever made by this store, including after release)."""
    holder: str
    token: int
    expires_at: float

    def expired(self, now: float) -> bool:
        return now >= self.expires_at


class LeaseStore:
    """File-backed lease with CAS semantics.

    ``ttl_s`` is how long a grant lives without renewal; ``clock`` is
    injectable (default ``time.monotonic`` — leases are meaningful within
    one host's clock domain; cross-host deployments would use a real
    coordination service, which this store models with the same API).
    """

    def __init__(self, path: str, *, ttl_s: float = 1.0, clock=time.monotonic):
        self.path = path
        self.ttl_s = float(ttl_s)
        self.clock = clock
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    # -- state -------------------------------------------------------------
    def read(self) -> Lease | None:
        """Current grant, or None if never granted / released."""
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except (FileNotFoundError, ValueError):
            return None
        if doc.get("holder") is None:
            return None
        return Lease(holder=doc["holder"], token=int(doc["token"]),
                     expires_at=float(doc["expires_at"]))

    def _last_token(self) -> int:
        """Highest token ever granted (survives release: the record keeps
        ``token`` with ``holder: null`` so monotonicity cannot reset)."""
        try:
            with open(self.path) as f:
                return int(json.load(f).get("token", -1))
        except (FileNotFoundError, ValueError):
            return -1

    def _write(self, doc: dict) -> None:
        tmp = self.path + f".tmp-{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, sort_keys=True, allow_nan=False)
            f.write("\n")
        os.rename(tmp, self.path)

    def _cas(self, fn):
        """Run ``fn()`` (read-modify-write) under the cross-process
        lockfile; a contender holding it briefly makes us spin."""
        lockfile = self.path + ".lock"
        with self._lock:
            deadline = time.monotonic() + 5.0
            while True:
                try:
                    fd = os.open(lockfile, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                    break
                except FileExistsError:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"lease lockfile {lockfile} wedged — stale "
                            "lock from a killed process?")
                    time.sleep(0.001)
            try:
                return fn()
            finally:
                os.close(fd)
                os.unlink(lockfile)

    # -- grants ------------------------------------------------------------
    def try_acquire(self, holder: str) -> Lease | None:
        """Claim or renew: succeeds if the lease is free, expired, or
        already ours (renewal keeps the token — same leadership term).
        A takeover mints ``last_token + 1``.  Returns None when someone
        else holds it unexpired."""
        def cas():
            now = self.clock()
            cur = self.read()
            if cur is not None and cur.holder != holder \
                    and not cur.expired(now):
                return None
            if cur is not None and cur.holder == holder \
                    and not cur.expired(now):
                token = cur.token          # renewal: same live term
            else:
                # free, expired, or even our *own* expired grant: a new
                # term — an expired token may have been beaten by a claim
                # this holder never observed, so it must never be reused
                token = self._last_token() + 1
            lease = Lease(holder=holder, token=token,
                          expires_at=now + self.ttl_s)
            self._write({"holder": lease.holder, "token": lease.token,
                         "expires_at": lease.expires_at})
            return lease
        lease = self._cas(cas)
        if lease is not None:
            obs.record_event("lease.acquired", holder=holder,
                             token=lease.token)
        return lease

    def renew(self, holder: str, token: int) -> Lease:
        """Extend our own unexpired-or-not grant; raises ``LeaseLost`` if
        a different holder/token has taken over (renewing an expired but
        untaken lease succeeds — no successor exists to conflict with)."""
        def cas():
            cur = self.read()
            if cur is None or cur.holder != holder or cur.token != token:
                raise LeaseLost(
                    f"{holder!r} token {token} superseded by "
                    f"{(cur.holder, cur.token) if cur else None}")
            lease = Lease(holder=holder, token=token,
                          expires_at=self.clock() + self.ttl_s)
            self._write({"holder": lease.holder, "token": lease.token,
                         "expires_at": lease.expires_at})
            return lease
        return self._cas(cas)

    def release(self, holder: str, token: int) -> None:
        """Step down voluntarily; keeps the token watermark on disk."""
        def cas():
            cur = self.read()
            if cur is None or cur.holder != holder or cur.token != token:
                raise LeaseLost(
                    f"{holder!r} token {token} cannot release — now "
                    f"{(cur.holder, cur.token) if cur else None}")
            self._write({"holder": None, "token": token})
        self._cas(cas)


class FenceGuard:
    """Zero-arg callable for ``WriteAheadLog(fence=...)``: raises
    ``FencedOut`` when this writer's token is no longer the store's.

    Runs on every append (under the WAL's append lock), so the decision
    uses the store's *current* record — no cached window a stale leader
    could slip an acknowledged write through.  The check is pure token
    comparison, not expiry: see the module docstring."""

    def __init__(self, store: LeaseStore, holder: str, token: int):
        self.store = store
        self.holder = holder
        self.token = token

    def __call__(self) -> None:
        cur = self.store.read()
        if cur is None or cur.token != self.token \
                or cur.holder != self.holder:
            obs.record_event(
                "lease.fenced", holder=self.holder, token=self.token,
                current=(cur.holder, cur.token) if cur else None)
            raise FencedOut(
                f"append fenced: {self.holder!r} holds token {self.token} "
                f"but lease is {(cur.holder, cur.token) if cur else None}")


@dataclasses.dataclass
class Promotion:
    """Result of :func:`promote`: the grant, the re-opened authoritative
    WAL (fence attached), and where replay ended."""
    lease: Lease
    wal: WriteAheadLog
    applied_seq: int
    digest: str


def promote(replica, store: LeaseStore, holder: str, *,
            target: tuple[int, str] | None = None,
            drain_timeout: float = 30.0, wal_kw: dict | None = None
            ) -> Promotion:
    """Fail a follower over into leadership.

    ``replica`` is a ``Replica`` or ``transport.ShippedReplica``; its WAL
    directory (the mirror, for a shipped one) becomes the authoritative
    log.  ``target`` is the last known acknowledged leader state — a
    ``(seq, digest)`` pair from ``ledger_digest`` — when available: the
    drain then *must* reach that seq and reproduce that digest
    (``DigestMismatch``/``TimeoutError`` otherwise), which is the
    zero-acknowledged-write-loss check.  Without a target the drain
    applies whatever tail is reachable and stops when dry (crash-
    consistent: everything acknowledged *and shipped* survives).

    Steps, in order — each gate must pass before the next:

    1. acquire the lease (new, higher fencing token); refuse to promote
       while the old leader's grant is live,
    2. drain the shipped tail through the normal replay path,
    3. verify the digest exchange against ``target`` if given,
    4. re-open the WAL directory with the new fence and attach it to the
       follower engine (``apply(..., log=True)`` now appends here).
    """
    obs.record_event("lease.promote_start", holder=holder)
    lease = store.try_acquire(holder)
    if lease is None:
        cur = store.read()
        raise LeaseLost(
            f"cannot promote {holder!r}: lease held by "
            f"{(cur.holder, cur.token) if cur else None} and not expired")

    plain = replica.replica if hasattr(replica, "replica") else replica
    if not isinstance(plain, Replica):
        raise TypeError(f"promote() wants a Replica/ShippedReplica, "
                        f"got {type(replica).__name__}")

    if target is not None:
        seq, digest = target
        # verify() drains through seq then compares digests; for a
        # shipped replica the pump below keeps pulling bytes too
        if hasattr(replica, "catch_up"):
            replica.catch_up(seq, timeout=drain_timeout)
        replica.verify(seq, digest, timeout=drain_timeout)
        applied, got = plain.digest()
    else:
        # drain until dry: poll until a full round moves nothing
        deadline = time.monotonic() + drain_timeout
        while True:
            try:
                n = replica.poll()
            except ConnectionError:
                n = 0           # ship source gone — mirror is all there is
            if n == 0:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"promotion drain of {holder!r} did not "
                                   f"go dry within {drain_timeout}s")
        applied, got = plain.digest()

    guard = FenceGuard(store, holder, lease.token)
    wal = WriteAheadLog(plain.wal_dir, fence=guard, **(wal_kw or {}))
    if wal.next_seq == 0:
        # empty mirror (promoted straight off a snapshot, no tail ever
        # shipped): seq numbering must continue from the snapshot's
        # high-water mark, not restart — replicas dedupe by seq
        wal.next_seq = applied + 1
    elif wal.next_seq != applied + 1:
        # mirror holds frames past what replay applied (a bounded-poll
        # budget left tail unapplied, or scan/apply drifted) — leading
        # from here would assign seqs the follower state never saw
        wal.close()
        raise RuntimeError(
            f"promotion of {holder!r} inconsistent: WAL next_seq "
            f"{wal.next_seq} vs applied seq {applied}")
    plain.follower.wal = wal
    obs.record_event("lease.promote_done", holder=holder,
                     token=lease.token, applied_seq=applied)
    return Promotion(lease=lease, wal=wal, applied_seq=applied, digest=got)
