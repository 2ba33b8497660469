"""Replica-aware query routing with graceful degradation.

``ServeFrontend`` coalesces queries against *one* engine; this router sits
in front of it and decides **which** engine answers — the leader (fresh
reads, the only write path) or a replica (scale-out reads, and the only
reads left when the leader is gone).  Three explicit modes, stamped on
every ticket so clients and dashboards see exactly what they got:

  * ``"leader"``   — routed through the leader's front-end; linearizable
    with the write stream (reads pin the epoch the last apply published).
  * ``"replica"``  — a healthy-leader read served from a follower for
    fan-out; only chosen when the follower satisfies the caller's session
    token, so it is still read-your-writes fresh *for that caller*.
  * ``"degraded"`` — the leader is unreachable (heartbeat misses over the
    limit): reads continue from the best-caught-up replica under an
    explicit **bounded-staleness contract** — the ticket carries
    ``staleness`` (records behind the leader's last acknowledged seq) and
    the router refuses replicas beyond ``max_staleness``.  Writes fail
    fast with ``LeaderUnavailable`` (retryable after failover) instead of
    queueing into a void.

**Read-your-writes** is a session property, not a global one: every
acknowledged write returns an updated :class:`SessionToken` ``(epoch,
wal_seq)``; a read carrying that token is only served by an engine whose
applied seq has reached ``wal_seq`` (the leader trivially qualifies).  A
token is a *floor*, so tokens from different sessions compose by max.

Failure detection is heartbeat-based and injectable: the monitor thread
calls ``ping()`` every interval (``stream.faults.FaultInjector.
drop_heartbeat`` starves deliveries in tests), and ``miss_limit``
consecutive misses flip the leader to down — reads degrade, writes bounce.
A later successful ping (or an explicit ``set_leader`` after
``stream.lease.promote``) flips it back.

Port of ``repro/serve/router.py``.  A replica read runs ``pinned_knn`` on
the replica's pinned epoch, on that epoch's device, one query at a time,
and its ticket holds CPU tensors, as a leader read's does.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.serve.frontend import _epoch_device, _to_host, pinned_knn

__all__ = ["SessionToken", "LeaderUnavailable", "StaleReplica",
           "RouterTicket", "ReplicaRouter"]


class LeaderUnavailable(ConnectionError):
    """No leader to write to (heartbeats lapsed, or none configured).
    Retryable: after ``stream.lease.promote`` a new leader is installed
    via ``set_leader`` and the same write succeeds."""


class StaleReplica(RuntimeError):
    """No replica satisfies the read's freshness bound — the session
    token demands records no reachable replica has applied, or every
    replica exceeds ``max_staleness`` while degraded."""


@dataclasses.dataclass(frozen=True)
class SessionToken:
    """Read-your-writes floor: the reader must observe state at least as
    new as ``(epoch, wal_seq)``.  Returned by every acknowledged write;
    pass the latest one to subsequent reads from the same session."""
    epoch: int = -1
    wal_seq: int = -1

    def merge(self, other: "SessionToken") -> "SessionToken":
        return SessionToken(epoch=max(self.epoch, other.epoch),
                            wal_seq=max(self.wal_seq, other.wal_seq))


class RouterTicket:
    """One routed read: result plus the routing facts — ``mode``
    ("leader" | "replica" | "degraded"), ``staleness`` (records behind
    the leader's last acknowledged seq at serve time; 0 on the leader),
    and the ``epoch`` pinned for the answer.  ``trace_id`` correlates the
    read across router/frontend/replica spans (None with obs off)."""
    __slots__ = ("mode", "staleness", "epoch", "dists", "ids", "err",
                 "trace_id", "_inner", "_event")

    def __init__(self, *, mode: str, staleness: int, trace_id=None):
        self.mode = mode
        self.staleness = staleness
        self.epoch = None
        self.dists = None
        self.ids = None
        self.err = None
        self.trace_id = trace_id
        self._inner = None            # leader-mode QueryTicket
        self._event = threading.Event()

    def done(self) -> bool:
        return (self._inner.done() if self._inner is not None
                else self._event.is_set())

    def result(self, timeout: float | None = None):
        """(dists [k], ids [k]) — raises the serve-path error, if any."""
        if self._inner is not None:
            d, i = self._inner.result(timeout)
            self.dists, self.ids, self.epoch = d, i, self._inner.epoch
            return d, i
        if not self._event.wait(timeout):
            raise TimeoutError("routed query not served within timeout")
        if self.err is not None:
            raise self.err
        return self.dists, self.ids


class ReplicaRouter:
    """Routes reads across a leader front-end and a set of replicas.

    ``leader`` is a started ``ServeFrontend`` (or None when leaderless —
    e.g. between a crash and a promotion).  ``replicas`` expose
    ``epochs`` / ``applied_seq`` / ``lag`` — ``stream.replica.Replica``
    and ``stream.transport.ShippedReplica`` both qualify.  ``ping`` is
    the leader liveness probe (default: the front-end reports itself
    running); ``fault`` threads the seeded chaos harness through the
    failure detector.

    ``prefer_replicas=True`` sends session-satisfying reads to replicas
    even while the leader is healthy (read fan-out); default is
    leader-first, replicas only on degradation.
    """

    def __init__(self, leader, replicas=(), *, ping=None,
                 fault=None, heartbeat_interval_s: float = 0.05,
                 miss_limit: int = 3, max_staleness: int | None = None,
                 prefer_replicas: bool = False, k: int = 8,
                 max_frontier: int = 64):
        self._leader = leader
        self.replicas = list(replicas)
        self._ping = ping
        self.fault = fault
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.miss_limit = int(miss_limit)
        self.max_staleness = max_staleness
        self.prefer_replicas = prefer_replicas
        self.k = k
        self.max_frontier = max_frontier
        self._lock = threading.Lock()
        self._misses = 0
        self._leader_up = leader is not None
        # monotonic time of the last successful heartbeat (None = never):
        # the snapshot's time_since_heartbeat_s gauge derives from this,
        # so recovery (a fresh ping / set_leader) resets it naturally
        self._last_ok_t = time.monotonic() if leader is not None else None
        self._running = False
        self._thread: threading.Thread | None = None
        self.n_heartbeats = 0
        self.n_heartbeat_misses = 0
        self.n_degraded_reads = 0
        self.n_replica_reads = 0
        self.n_leader_reads = 0

    # -- leader membership -------------------------------------------------
    @property
    def leader(self):
        with self._lock:
            return self._leader

    @property
    def leader_up(self) -> bool:
        with self._lock:
            return self._leader is not None and self._leader_up

    def set_leader(self, frontend) -> None:
        """Install a (newly promoted) leader front-end; resets the
        failure detector.  ``None`` declares the cluster leaderless."""
        with self._lock:
            was_up = self._leader_up and self._leader is not None
            self._leader = frontend
            self._leader_up = frontend is not None
            self._misses = 0
            if frontend is not None:
                self._last_ok_t = time.monotonic()
        if frontend is not None and not was_up:
            obs.record_event("router.leader_installed")

    def mark_leader_down(self) -> None:
        """Out-of-band failure signal (a write path saw a hard error)."""
        with self._lock:
            self._leader_up = False

    # -- failure detection -------------------------------------------------
    def _default_ping(self) -> bool:
        fe = self._leader
        return bool(fe is not None and getattr(fe, "_running", False))

    def heartbeat(self) -> bool:
        """One detector step; returns the post-step leader_up verdict.
        A starved delivery (fault injection, or a real timeout modelled
        by ``ping`` raising/returning False) counts as a miss; misses
        are consecutive — one success resets."""
        self.n_heartbeats += 1
        delivered = not (self.fault is not None
                         and self.fault.drop_heartbeat())
        ok = False
        if delivered:
            try:
                ok = bool((self._ping or self._default_ping)())
            except Exception:  # noqa: BLE001 — probe failure is a miss
                ok = False
        flip = None
        with self._lock:
            was_up = self._leader_up and self._leader is not None
            if ok:
                self._misses = 0
                self._last_ok_t = time.monotonic()
                if self._leader is not None:
                    self._leader_up = True
            else:
                self._misses += 1
                self.n_heartbeat_misses += 1
                if self._misses >= self.miss_limit:
                    self._leader_up = False
            now_up = self._leader_up and self._leader is not None
            if now_up != was_up:
                flip = ("router.leader_recovered" if now_up
                        else "router.leader_down")
            misses = self._misses
        if obs.enabled():
            obs.counter("router.heartbeats_total").inc()
            if not ok:
                obs.counter("router.heartbeat_misses_total").inc()
            obs.gauge("router.leader_up").set(1.0 if now_up else 0.0)
            obs.gauge("router.consecutive_misses").set(misses)
            if flip is not None:
                obs.record_event(flip, misses=misses)
        return now_up

    def start(self) -> "ReplicaRouter":
        """Run the failure detector on a daemon thread."""
        if self._running:
            return self
        self._running = True

        def monitor():
            while self._running:
                self.heartbeat()
                time.sleep(self.heartbeat_interval_s)

        self._thread = threading.Thread(target=monitor, name="router-hb",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self) -> "ReplicaRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- writes ------------------------------------------------------------
    def mutate(self, ops, xs, oids, *, timeout: float | None = 60.0):
        """Apply one mutation batch through the leader; returns
        ``(BatchResult, SessionToken)`` — the token is the caller's new
        read-your-writes floor.  Raises :class:`LeaderUnavailable` when
        there is no live leader (fail fast; retry after failover)."""
        with self._lock:
            fe = self._leader if self._leader_up else None
        if fe is None:
            raise LeaderUnavailable(
                "no live leader to accept writes (degraded mode serves "
                "reads only) — retry after failover")
        mspan = obs.start_span("router.mutate", n=len(ops))
        try:
            tk = fe.submit_mutations(ops, xs, oids, trace_ctx=mspan.ctx)
            res = tk.result(timeout)
        except LeaderUnavailable:
            mspan.end(error="LeaderUnavailable")
            raise
        except (RuntimeError, ConnectionError) as e:
            # a hard apply error (fenced-out deposed leader, stopped
            # front-end) flips the detector immediately — waiting for
            # heartbeat misses would bounce more writes for no reason
            mspan.end(error=type(e).__name__)
            if type(e).__name__ in ("FencedOut",) \
                    or "stopped" in str(e).lower():
                self.mark_leader_down()
                obs.record_event("router.leader_marked_down",
                                 reason=type(e).__name__)
                raise LeaderUnavailable(f"leader lost mid-write: {e}") from e
            raise
        mspan.end()
        eng = fe.engine
        seq = eng.wal.next_seq - 1 if eng.wal is not None else -1
        with eng.epochs.reading(with_epoch=True) as (epoch, _):
            token = SessionToken(epoch=epoch, wal_seq=seq)
        return res, token

    # -- reads -------------------------------------------------------------
    def _replica_view(self):
        """(replica, applied_seq, staleness) triples, freshest first."""
        views = []
        for r in self.replicas:
            views.append((r, int(r.applied_seq), int(r.lag)))
        views.sort(key=lambda v: v[1], reverse=True)
        return views

    def _serve_from(self, ticket: RouterTicket, replica, q: np.ndarray,
                    parent=None):
        span = obs.start_span("router.replica_serve", parent=parent,
                              sampled=True,
                              mode=ticket.mode, staleness=ticket.staleness)
        try:
            with replica.epochs.reading(with_epoch=True) as (e, pinned):
                qd = torch.from_numpy(q[None, :]).to(_epoch_device(pinned))
                d, i = _to_host(*pinned_knn(pinned, qd, k=self.k,
                                            max_frontier=self.max_frontier))
            ticket.dists, ticket.ids, ticket.epoch = d[0], i[0], e
            span.end(epoch=e)
        except Exception as exc:  # noqa: BLE001 — fail the ticket
            ticket.err = exc
            span.end(error=type(exc).__name__)
        finally:
            ticket._event.set()

    def query(self, q: np.ndarray,
              session: SessionToken | None = None) -> RouterTicket:
        """Route one read.  Leader-first unless ``prefer_replicas``;
        degrades to bounded-staleness replica serving when the leader is
        down.  ``session`` (from a prior write) is the freshness floor —
        a replica that hasn't applied ``session.wal_seq`` is skipped, and
        if nothing qualifies the call raises :class:`StaleReplica` rather
        than silently serving older state."""
        q = np.asarray(q, np.float32)
        floor = session.wal_seq if session is not None else -1
        up = self.leader_up
        rspan = obs.start_span("router.query", floor=floor, sampled=True)

        if up and not self.prefer_replicas:
            ticket = RouterTicket(mode="leader", staleness=0,
                                  trace_id=rspan.trace_id)
            ticket._inner = self.leader.submit(q, trace_ctx=rspan.ctx)
            self.n_leader_reads += 1
            self._count_read("leader")
            rspan.end(mode="leader")
            return ticket

        mode = "replica" if up else "degraded"
        for replica, applied, stale in self._replica_view():
            if applied < floor:
                continue
            if (mode == "degraded" and self.max_staleness is not None
                    and stale > self.max_staleness):
                continue
            ticket = RouterTicket(mode=mode, staleness=stale,
                                  trace_id=rspan.trace_id)
            self._serve_from(ticket, replica, q, parent=rspan.ctx)
            if mode == "degraded":
                self.n_degraded_reads += 1
            else:
                self.n_replica_reads += 1
            self._count_read(mode)
            rspan.end(mode=mode, staleness=stale)
            return ticket

        if up:
            # healthy leader is always a valid fallback for fan-out reads
            ticket = RouterTicket(mode="leader", staleness=0,
                                  trace_id=rspan.trace_id)
            ticket._inner = self.leader.submit(q, trace_ctx=rspan.ctx)
            self.n_leader_reads += 1
            self._count_read("leader")
            rspan.end(mode="leader")
            return ticket
        rspan.end(error="StaleReplica")
        raise StaleReplica(
            f"no replica satisfies session floor seq {floor}"
            + (f" within max_staleness {self.max_staleness}"
               if self.max_staleness is not None else "")
            + " and the leader is unreachable")

    def knn(self, qs: np.ndarray, session: SessionToken | None = None,
            timeout: float | None = 60.0):
        """Synchronous convenience over :meth:`query` for a [b, dim]
        block: (dists [b, k], ids [b, k], tickets), CPU tensors."""
        qs = np.asarray(qs, np.float32)
        tickets = [self.query(q, session) for q in qs]
        out = [t.result(timeout) for t in tickets]
        return (torch.stack([d for d, _ in out]),
                torch.stack([i for _, i in out]), tickets)

    # -- observability -----------------------------------------------------
    @staticmethod
    def _count_read(mode: str) -> None:
        if obs.enabled():
            obs.counter(f"router.{mode}_reads_total").inc()

    def snapshot(self) -> dict:
        with self._lock:
            up = self._leader_up and self._leader is not None
            misses = self._misses
            last_ok = self._last_ok_t
        lags = [int(r.lag) for r in self.replicas]
        # gauges, not mode strings: how long since the detector last saw
        # the leader (-1 = never), and the staleness a read served *now*
        # would carry — 0 on a live leader, the freshest qualifying
        # replica's lag when degraded (-1 = degraded with no replicas).
        since_hb = (time.monotonic() - last_ok) if last_ok is not None \
            else -1.0
        staleness = 0 if up else (min(lags) if lags else -1)
        if obs.enabled():
            obs.gauge("router.time_since_heartbeat_s").set(since_hb)
            obs.gauge("router.staleness").set(float(staleness))
            obs.gauge("router.max_replica_lag").set(
                float(max(lags, default=0)))
        return {"leader_up": up, "consecutive_misses": misses,
                "time_since_heartbeat_s": since_hb,
                "staleness": staleness,
                "n_heartbeats": self.n_heartbeats,
                "n_heartbeat_misses": self.n_heartbeat_misses,
                "n_leader_reads": self.n_leader_reads,
                "n_replica_reads": self.n_replica_reads,
                "n_degraded_reads": self.n_degraded_reads,
                "replica_lags": lags,
                "max_replica_lag": max(lags, default=0)}
