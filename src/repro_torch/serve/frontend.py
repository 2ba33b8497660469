"""Async serving front-end: admission queue + cohort scheduler.

Port of ``repro/serve/frontend.py``.  The engine's cohort descent serves a
``[b, dim]`` batch in one call, but only a caller that already *has* such a
batch can reach it.  This module forms those batches from independent
clients:

  * **Admission queue** — clients ``submit()`` single queries (or
    ``submit_many`` a block) and get tickets; a dispatcher thread coalesces
    pending requests into **fixed-geometry cohorts** under a latency SLO.
    The dispatch rule is *deadline-or-batch-full*: a cohort launches the
    moment ``cohort_width`` requests are waiting, or when the oldest
    admitted request has been queued for ``slo_ms`` — whichever comes
    first.  Cohorts are always padded to ``cohort_width`` on the host (pad
    rows are zero queries whose results are discarded), so fill and the
    sampled level stats count the same rows as the reference's, and every
    cohort has one shape.
  * **One copy each way** — the padded cohort goes to the engine's device
    in one host-to-device copy, and its distances and ids come back in one
    device-to-host copy (the ids ride as the bits of f32 beside the
    distances).  Tickets hold CPU tensors.
  * **Epoch pinning** — each cohort runs under the
    ``EpochManager.reading()`` contract: the snapshot is pinned before the
    descent starts and released after results are sliced out, so a
    concurrent writer can publish and retire epochs freely and no query
    ever observes a tree swap mid-cohort.  Every ticket records the epoch
    that answered it.
  * **Cohort scheduler** — mutation batches go through a second queue
    drained by a writer thread that applies them via the engine's
    WAL-first ``apply`` (each apply ends in an epoch publish).  Reads come
    from pinned epochs on the dispatcher thread while the writer builds
    the next version.

Both threads issue their device work on the same CUDA stream (the current
stream of a new thread is the device's default stream): a retired epoch's
memory returns to the caching allocator and can be handed to the writer
only in stream order, after every cohort queued before it.  The batch
apply is a Python row loop that holds the interpreter lock, so a cohort
dispatched during an apply waits for it; ``FrontendStats`` times cohorts
that overlapped an apply apart from those that did not.

Works over a ``StreamingEngine`` (single tree) or ``StreamingForest``
(pinned epoch = tuple of shard trees; per-shard descent + top-k merge, the
same read path ``StreamingForest.knn`` uses).
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import smtree

__all__ = ["FrontendConfig", "FrontendStats", "QueryTicket",
           "MutationTicket", "QueueFull", "ServeFrontend", "pinned_knn"]


class QueueFull(RuntimeError):
    """Admission rejected: the queue is at capacity and the front-end is
    configured to shed rather than block.  ``retry_after_s`` is a hint —
    the time the current backlog needs to drain at the configured cohort
    cadence — suitable for a Retry-After header or client backoff."""

    def __init__(self, msg: str, *, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class FrontendConfig:
    cohort_width: int = 64    # fixed dispatch geometry (pad-to-width)
    slo_ms: float = 5.0       # max queue age before a partial cohort ships
    k: int = 8
    max_frontier: int = 64
    queue_cap: int = 4096     # admission bound (blocks or sheds when full)
    mutation_queue_cap: int = 1024  # mutation backlog bound
    # "block": a full queue stalls the submitter (in-process callers).
    # "shed": raise QueueFull with a retry-after hint — the right shape in
    # front of a network, where a blocked socket just moves the unbounded
    # queue into the kernel.
    overload: str = "block"
    # scheduler slot for background repair: after each mutation batch the
    # daemon offers the engine one bounded ``maintenance()`` call (a
    # forest runs at most one migration step per offer)
    maintenance: bool = True


def pinned_knn(pinned, queries, *, k: int, max_frontier: int, _scorer=None):
    """kNN over one pinned epoch: a single tree, or a tuple of forest
    shards (per-shard cohort descent, then the top-k of the shard-major
    candidates by a stable sort: equal distances keep the lowest shard,
    then the lowest rank, as the reference's ``np.argsort(kind="stable")``
    does).  Returns (dists [b, k] f32, ids [b, k] int32) on the shards'
    device.

    With observability on, a 1/``obs.LEVEL_STATS_EVERY`` sample of
    dispatches runs the level-stats descent and accumulates the paper
    counters (queries, distance evals, nodes visited, pruned per level).
    ``_scorer`` is private, as in ``smtree.knn``: it replaces the frontier
    scorer, so a caller can hold the kernel against the plain version."""
    if not isinstance(pinned, (tuple, list)):
        pinned = (pinned,)
    on = obs.enabled()
    ds, ids = [], []
    for t in pinned:
        if on and obs.want_level_stats():
            res, pruned = smtree.knn(t, queries, k=k,
                                     max_frontier=max_frontier,
                                     level_stats=True, _scorer=_scorer)
            obs.observe_query_result(res, pruned)
        else:
            res = smtree.knn(t, queries, k=k, max_frontier=max_frontier,
                             _scorer=_scorer)
        ds.append(res.dists)
        ids.append(res.ids)
    d, sel = smtree._smallest(torch.cat(ds, dim=1), k)
    return d, torch.cat(ids, dim=1).gather(1, sel)


def _epoch_device(pinned) -> torch.device:
    tree = pinned[0] if isinstance(pinned, (tuple, list)) else pinned
    return tree.device


def _to_host(d: torch.Tensor, ids: torch.Tensor):
    """(dists, ids) of a cohort on the CPU in one device-to-host copy: the
    int32 ids travel as the bits of f32 columns beside the distances."""
    k = d.shape[1]
    both = torch.cat([d.float(), ids.to(torch.int32).view(torch.float32)], 1).cpu()
    return both[:, :k], both[:, k:].view(torch.int32)


class QueryTicket:
    """One admitted query.  ``result()`` blocks until its cohort ran.

    ``span`` is the ticket's root trace span ("frontend.query"), opened
    at admission and ended when the cohort stamps results; the shared
    no-op span when observability is off or head sampling skipped this
    ticket (``obs.set_trace_sampling``).  ``trace_id`` (None when not
    traced) lets callers correlate the ticket across layers."""
    __slots__ = ("q", "t_submit", "t_done", "epoch", "dists", "ids", "err",
                 "span", "_event")

    def __init__(self, q: np.ndarray, trace_ctx=None):
        self.q = q
        self.t_submit = time.monotonic()
        self.t_done = None
        self.epoch = None        # epoch number the cohort was pinned to
        self.dists = None        # [k] f32 CPU tensor
        self.ids = None          # [k] int32 CPU tensor
        self.err = None
        # sample_root() decides head sampling without the start_span
        # kwargs call — the unsampled majority of tickets pays one
        # cheap predicate, not a span-construction attempt
        if trace_ctx is not None or obs.sample_root():
            self.span = obs.start_span("frontend.query", parent=trace_ctx)
        else:
            self.span = obs.NULL_SPAN
        self._event = threading.Event()

    @property
    def trace_id(self):
        return self.span.trace_id

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        """(dists [k], ids [k]) — raises the cohort's error, if any."""
        if not self._event.wait(timeout):
            raise TimeoutError("query ticket not served within timeout")
        if self.err is not None:
            raise self.err
        return self.dists, self.ids

    @property
    def latency_s(self) -> float:
        return (self.t_done or time.monotonic()) - self.t_submit


class MutationTicket:
    """One queued mutation batch; resolves to its ``BatchResult``."""
    __slots__ = ("ops", "xs", "oids", "res", "err", "span", "_event")

    def __init__(self, ops, xs, oids, trace_ctx=None):
        self.ops, self.xs, self.oids = ops, xs, oids
        self.res = None
        self.err = None
        self.span = obs.start_span("frontend.mutation", parent=trace_ctx)
        self._event = threading.Event()

    @property
    def trace_id(self):
        return self.span.trace_id

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("mutation batch not applied within timeout")
        if self.err is not None:
            raise self.err
        return self.res


def _p50_ms(h: obs.Histogram) -> float | None:
    return None if h.count == 0 else round(h.percentile(50) * 1e3, 3)


@dataclasses.dataclass
class FrontendStats:
    """Serving counters (updated under the front-end lock)."""
    n_queries: int = 0
    n_cohorts: int = 0
    n_full_dispatch: int = 0      # cohorts shipped because width was reached
    n_deadline_dispatch: int = 0  # cohorts shipped by the SLO deadline
    n_mutation_batches: int = 0
    n_maintenance: int = 0        # maintenance slots that did repair work
    n_shed: int = 0               # admissions rejected with QueueFull
    queue_depth: int = 0          # gauges, updated on every queue touch
    mutation_queue_depth: int = 0
    fill_sum: int = 0             # real (unpadded) rows across cohorts
    # fixed-bucket histograms, not sample lists: O(n_buckets) memory
    # forever under sustained load.  Constructed standalone (always-on),
    # because snapshot()/latency_ms report with obs off.
    latency_hist: obs.Histogram = dataclasses.field(
        default_factory=lambda: obs.Histogram(
            "frontend.latency_s", obs.LATENCY_BUCKETS_S))
    # a cohort's service time (pin, descent, copy back), apart by whether
    # a mutation batch was being applied while it ran
    cohort_hist: obs.Histogram = dataclasses.field(
        default_factory=lambda: obs.Histogram(
            "frontend.cohort_s", obs.LATENCY_BUCKETS_S))
    behind_apply_hist: obs.Histogram = dataclasses.field(
        default_factory=lambda: obs.Histogram(
            "frontend.cohort_behind_apply_s", obs.LATENCY_BUCKETS_S))

    def observe_cohort(self, fill: int, full: bool, lats, service_s: float,
                       behind_apply: bool) -> None:
        self.n_cohorts += 1
        self.n_queries += fill
        self.fill_sum += fill
        if full:
            self.n_full_dispatch += 1
        else:
            self.n_deadline_dispatch += 1
        self.latency_hist.observe_many(lats)
        (self.behind_apply_hist if behind_apply
         else self.cohort_hist).observe(service_s)

    def publish(self, fill: int, full: bool) -> None:
        """Export the cohort's registry metrics.  Split from
        ``observe_cohort`` so the dispatcher can call it *outside* the
        front-end's condition lock — registry work must not extend the
        critical section admitting submitters."""
        if not obs.enabled():
            return
        obs.counter("frontend.queries_total").inc(fill)
        obs.counter("frontend.cohorts_total").inc()
        obs.counter("frontend.full_dispatch_total" if full
                    else "frontend.deadline_dispatch_total").inc()
        obs.gauge("frontend.queue_depth").set(self.queue_depth)
        obs.gauge("frontend.mean_cohort_fill").set(self.mean_fill)
        # the always-on histograms already saw every sample; adopting them
        # into the registry exports them without a second observe pass
        for h in (self.latency_hist, self.cohort_hist, self.behind_apply_hist):
            obs.REGISTRY.register(h)

    @property
    def mean_fill(self) -> float:
        return self.fill_sum / max(1, self.n_cohorts)

    def latency_ms(self, pct: float) -> float:
        if self.latency_hist.count == 0:
            return float("nan")
        return self.latency_hist.percentile(pct) * 1e3

    def snapshot(self) -> dict:
        return {"n_queries": self.n_queries, "n_cohorts": self.n_cohorts,
                "n_full_dispatch": self.n_full_dispatch,
                "n_deadline_dispatch": self.n_deadline_dispatch,
                "n_mutation_batches": self.n_mutation_batches,
                "n_shed": self.n_shed,
                "queue_depth": self.queue_depth,
                "mutation_queue_depth": self.mutation_queue_depth,
                "mean_cohort_fill": round(self.mean_fill, 2),
                "p50_ms": round(self.latency_ms(50), 3),
                "p99_ms": round(self.latency_ms(99), 3),
                "n_cohorts_behind_apply": self.behind_apply_hist.count,
                "cohort_p50_ms": _p50_ms(self.cohort_hist),
                "cohort_behind_apply_p50_ms": _p50_ms(self.behind_apply_hist)}


class ServeFrontend:
    """Admission queue + cohort scheduler over a streaming engine/forest.

    ``engine`` must expose ``.epochs`` (an ``EpochManager``) and
    ``.apply(ops, xs, oids)`` (the WAL-first batch apply that publishes an
    epoch) — both ``StreamingEngine`` and ``StreamingForest`` qualify.
    ``knn_fn(pinned, queries) -> (dists [b,k], ids [b,k])`` overrides the
    default pinned descent (``pinned_knn``); ``queries`` is the padded
    cohort on the pinned epoch's device.

    Use as a context manager, or ``start()``/``stop()`` explicitly::

        with ServeFrontend(eng, FrontendConfig(cohort_width=64)) as fe:
            d, i = fe.knn(queries)            # coalesced, epoch-pinned
            fe.submit_mutations(ops, xs, oids)  # rides behind serving
    """

    def __init__(self, engine, cfg: FrontendConfig | None = None, *,
                 knn_fn=None):
        self.engine = engine
        self.cfg = cfg or FrontendConfig()
        if self.cfg.cohort_width < 1:
            raise ValueError("cohort_width must be >= 1")
        self._knn_fn = knn_fn or (lambda pinned, q: pinned_knn(
            pinned, q, k=self.cfg.k, max_frontier=self.cfg.max_frontier))
        self.stats = FrontendStats()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: list[QueryTicket] = []
        self._mutations: list[MutationTicket] = []
        self._inflight = 0            # queries taken off the queue, not done
        self._mut_inflight = 0
        self._applies = 0             # mutation batches started (a cohort
        self._applying = False        # that sees these move ran beside one)
        self._running = False
        self._threads: list[threading.Thread] = []

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ServeFrontend":
        with self._lock:
            if self._running:
                return self
            self._running = True
        self._threads = [
            threading.Thread(target=self._dispatch_loop,
                             name="frontend-dispatch", daemon=True),
            threading.Thread(target=self._mutation_loop,
                             name="frontend-mutate", daemon=True),
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        """Stop the worker threads.  ``drain=True`` (default) serves every
        admitted request and applies every queued mutation first; False
        fails the leftovers with a RuntimeError."""
        if drain and self._running:
            self.drain()
        with self._cond:
            self._running = False
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=30)
        self._threads = []
        with self._cond:
            leftovers = self._queue + self._mutations
            self._queue, self._mutations = [], []
        for tk in leftovers:
            tk.err = RuntimeError("front-end stopped before dispatch")
            tk._event.set()

    def __enter__(self) -> "ServeFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc == (None, None, None))

    def drain(self, timeout: float | None = None) -> None:
        """Block until both queues are empty and nothing is in flight."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while (self._queue or self._mutations or self._inflight
                   or self._mut_inflight):
                left = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                if left == 0.0:
                    raise TimeoutError("front-end did not drain in time")
                self._cond.wait(left if left is not None else 0.1)

    # -- admission ---------------------------------------------------------
    def _retry_after_s(self, depth: int) -> float:
        """Drain-time hint for a shed client: the backlog in cohorts,
        paced at one SLO window per cohort (the dispatcher's worst-case
        cadence — it runs faster when cohorts fill early)."""
        cohorts = max(1, -(-depth // self.cfg.cohort_width))
        return cohorts * self.cfg.slo_ms / 1e3

    def _shed(self, tk, queue: str, depth: int, cap: int) -> QueueFull:
        self.stats.n_shed += 1
        if obs.enabled():
            obs.counter("frontend.shed_total").inc()
            obs.record_event("frontend.shed", queue=queue, depth=depth)
        tk.span.end(error="QueueFull")
        name = "admission" if queue == "query" else "mutation"
        return QueueFull(f"{name} queue at cap ({cap})",
                         retry_after_s=self._retry_after_s(depth))

    def submit(self, q, *, trace_ctx=None) -> QueryTicket:
        """Admit one query [dim]; returns its ticket.  At ``queue_cap``
        the configured overload policy applies: ``"block"`` stalls the
        caller until space frees (backpressure), ``"shed"`` raises
        :class:`QueueFull` with a retry-after hint instead of letting the
        backlog — and every admitted request's latency — grow without
        bound.  ``trace_ctx`` parents the ticket's trace span on an
        upstream caller (the router's per-read span)."""
        if not self._running:
            raise RuntimeError("front-end not started")
        tk = QueryTicket(np.asarray(q, np.float32), trace_ctx)
        with self._cond:
            if (self.cfg.overload == "shed"
                    and len(self._queue) >= self.cfg.queue_cap):
                raise self._shed(tk, "query", len(self._queue),
                                 self.cfg.queue_cap)
            while len(self._queue) >= self.cfg.queue_cap and self._running:
                self._cond.wait(0.05)
            if not self._running:
                raise RuntimeError("front-end stopped")
            self._queue.append(tk)
            self.stats.queue_depth = len(self._queue)
            self._cond.notify_all()
        return tk

    def submit_many(self, qs) -> list[QueryTicket]:
        """Admit a [b, dim] block as b tickets (they coalesce like any
        other traffic — a b <= width block from one client usually lands
        in a single cohort)."""
        return [self.submit(q) for q in np.asarray(qs, np.float32)]

    def knn(self, qs, timeout: float | None = 60.0):
        """Synchronous convenience: admit [b, dim], wait, return
        (dists [b, k], ids [b, k]) as CPU tensors."""
        tickets = self.submit_many(qs)
        out = [t.result(timeout) for t in tickets]
        return (torch.stack([d for d, _ in out]),
                torch.stack([i for _, i in out]))

    def submit_mutations(self, ops, xs, oids, *,
                         trace_ctx=None) -> MutationTicket:
        """Queue one mutation batch for the scheduler; returns a ticket
        resolving to its ``BatchResult``.  Fire-and-forget callers simply
        drop the ticket — ``drain()``/``stop()`` still applies it.  The
        backlog is bounded by ``mutation_queue_cap`` under the same
        overload policy as queries."""
        if not self._running:
            raise RuntimeError("front-end not started")
        tk = MutationTicket(np.asarray(ops, np.int32),
                            np.asarray(xs, np.float32),
                            np.asarray(oids, np.int32), trace_ctx)
        with self._cond:
            if (self.cfg.overload == "shed"
                    and len(self._mutations) >= self.cfg.mutation_queue_cap):
                raise self._shed(tk, "mutation", len(self._mutations),
                                 self.cfg.mutation_queue_cap)
            while (len(self._mutations) >= self.cfg.mutation_queue_cap
                   and self._running):
                self._cond.wait(0.05)
            if not self._running:
                raise RuntimeError("front-end stopped")
            self._mutations.append(tk)
            self.stats.mutation_queue_depth = len(self._mutations)
            self._cond.notify_all()
        return tk

    # -- dispatcher (query cohorts) ---------------------------------------
    def _dispatch_loop(self) -> None:
        W = self.cfg.cohort_width
        slo_s = self.cfg.slo_ms / 1e3
        while True:
            with self._cond:
                while not self._queue and self._running:
                    self._cond.wait(0.05)
                if not self._queue:
                    return                      # stopped and empty
                # deadline-or-batch-full: wait for a full cohort only
                # until the oldest admitted request hits the SLO
                deadline = self._queue[0].t_submit + slo_s
                while len(self._queue) < W and self._running:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(left)
                batch = self._queue[:W]
                del self._queue[:len(batch)]
                self._inflight += len(batch)
                self.stats.queue_depth = len(self._queue)
                self._cond.notify_all()
            self._run_cohort(batch, full=len(batch) == W)

    def _run_cohort(self, batch: list[QueryTicket], *, full: bool) -> None:
        W = self.cfg.cohort_width
        n = len(batch)
        t0 = time.monotonic()
        applies0, applying0 = self._applies, self._applying
        # Cohort fan-in: the cohort span parents on the first *traced*
        # member ticket and *links* every other traced member's
        # trace_id, so each sampled ticket's trace reaches the shared
        # pin/compute spans.  A cohort with no traced member skips the
        # cohort-side spans entirely.
        cspan = obs.NULL_SPAN
        if obs.enabled():
            members = [tk for tk in batch if tk.span is not obs.NULL_SPAN]
            if members:
                cspan = obs.start_span(
                    "frontend.cohort", parent=members[0].span.ctx,
                    links=tuple(tk.span.trace_id for tk in members[1:]),
                    fill=n, width=W, full=full)
        traced = cspan is not obs.NULL_SPAN
        try:
            dim = batch[0].q.shape[-1]
            Q = np.zeros((W, dim), np.float32)   # pad-to-width: one geometry
            for r, tk in enumerate(batch):
                Q[r] = tk.q
            pin = (obs.start_span("frontend.epoch_pin", parent=cspan.ctx)
                   if traced else obs.NULL_SPAN)
            with self.engine.epochs.reading(with_epoch=True) as (e, pinned):
                pin.end(epoch=e)
                comp = (obs.start_span("frontend.device_compute",
                                       parent=cspan.ctx)
                        if traced else obs.NULL_SPAN)
                q = torch.from_numpy(Q).to(_epoch_device(pinned))
                d, ids = self._knn_fn(pinned, q)
                comp.end()
                reply = (obs.start_span("frontend.reply", parent=cspan.ctx)
                         if traced else obs.NULL_SPAN)
                d, ids = _to_host(torch.as_tensor(d), torch.as_tensor(ids))
            t_done = time.monotonic()
            for r, tk in enumerate(batch):
                tk.dists, tk.ids, tk.epoch = d[r], ids[r], e
                tk.t_done = t_done
            reply.end()
        except Exception as exc:  # noqa: BLE001 — fail the cohort's tickets
            cspan.set(error=type(exc).__name__)
            for tk in batch:
                tk.err = exc
        finally:
            cspan.end()
            for tk in batch:
                if tk.span is not obs.NULL_SPAN:
                    if tk.err is not None:
                        tk.span.set(error=type(tk.err).__name__)
                    tk.span.end(epoch=tk.epoch)
                tk._event.set()
            behind = (applying0 or self._applying
                      or self._applies != applies0)
            with self._cond:
                self._inflight -= n
                self.stats.observe_cohort(
                    n, full,
                    [tk.latency_s for tk in batch if tk.err is None],
                    time.monotonic() - t0, behind)
                self._cond.notify_all()
            self.stats.publish(n, full)

    # -- scheduler (mutation batches) -------------------------------------
    def _mutation_loop(self) -> None:
        while True:
            with self._cond:
                while not self._mutations and self._running:
                    self._cond.wait(0.05)
                if not self._mutations:
                    return                      # stopped and empty
                tk = self._mutations.pop(0)
                self._mut_inflight += 1
                self.stats.mutation_queue_depth = len(self._mutations)
                self._applies += 1
                self._applying = True
            try:
                # the engine's WAL-first apply; ends in an epoch publish,
                # so the batch becomes visible to the *next* cohort pin —
                # in-flight cohorts keep their pinned snapshot.  The span
                # becomes the thread-local current, so the engine's
                # wal.append/apply/publish child spans attach to it.
                with obs.span("frontend.mutation_batch",
                              parent=tk.span.ctx, n=len(tk.ops)):
                    tk.res = self.engine.apply(tk.ops, tk.xs, tk.oids)
            except Exception as exc:  # noqa: BLE001 — fail the ticket
                tk.err = exc
                if tk.span is not obs.NULL_SPAN:
                    tk.span.set(error=type(exc).__name__)
            else:
                # scheduler slot: one bounded repair offer per applied
                # batch, on this same single-writer thread (migration
                # steps and mutation batches must serialize — both mutate
                # the trees, and the WAL order is the replay contract).
                # A repair failure is recorded as a fault, not surfaced on
                # the user's ticket — their batch already applied.
                if self.cfg.maintenance:
                    try:
                        maint = getattr(self.engine, "maintenance", None)
                        if maint is not None and maint():
                            with self._cond:
                                self.stats.n_maintenance += 1
                    except Exception as exc:  # noqa: BLE001
                        obs.record_fault("frontend.maintenance", exc)
            finally:
                self._applying = False
                tk.span.end()
                tk._event.set()
                with self._cond:
                    self._mut_inflight -= 1
                    self.stats.n_mutation_batches += 1
                    if obs.enabled():
                        obs.counter("frontend.mutation_batches_total").inc()
                        obs.gauge("frontend.mutation_queue_depth").set(
                            len(self._mutations))
                    self._cond.notify_all()
