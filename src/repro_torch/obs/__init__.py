"""Process-wide observability plane (DESIGN.md §15).  Port of
``repro/obs/__init__.py``: the same instrument names, buckets and
disabled-path contract; ``observe_query_result`` reads the port's
``QueryResult`` tensors on the host.

Four pieces behind one switch:

* :mod:`repro.obs.registry` — lock-cheap counters / gauges /
  fixed-bucket histograms (p50/p95/p99, bounded memory).
* :mod:`repro.obs.trace` — structured spans threading one ``trace_id``
  through a query ticket or mutation batch across threads and layers.
* :mod:`repro.obs.recorder` — bounded flight-recorder ring of recent
  spans + state-transition events, dumped to JSON on ``FencedOut`` /
  ``ShipStall`` / ``DigestMismatch`` / chaos assertions.
* :mod:`repro.obs.export` — `/metrics`-style JSON snapshot, served over
  the ship-server socket and by ``launch/serve.py --obs``.

Usage::

    from repro_torch import obs

    obs.enable()
    obs.counter("wal.appends_total").inc(b)
    with obs.span("mutation.apply", n=b):
        ...
    obs.record_event("router.leader_down", misses=3)
    obs.record_fault("wal.fenced_out", exc)        # event + JSON dump
    snap = obs.export.metrics_snapshot()

**Disabled-path contract**: everything above is a single shared-flag
check when ``obs`` is off — no locks, no allocation, no clock reads, no
ring appends.  The serving hot paths keep this contract by hoisting the
check (``if obs.enabled(): …``) around any work needed to *build*
metric values (device fetches, percentile math).
"""

from __future__ import annotations

import itertools

from . import export, recorder, registry, trace
from .recorder import FlightRecorder
from .registry import (DEFAULT_BUCKETS, LATENCY_BUCKETS_S, Counter, Gauge,
                       Histogram, Registry, _Gate)
from .trace import (NULL_SPAN, Span, SpanCtx, assemble_trace, current_ctx,
                    new_trace_id, sample_root, span, start_span,
                    trace_connected)

__all__ = [
    "REGISTRY", "RECORDER",
    "enabled", "enable", "disable", "reset",
    "counter", "gauge", "histogram",
    "span", "start_span", "current_ctx", "new_trace_id", "sample_root",
    "record_event", "record_fault",
    "observe_query_result", "want_level_stats", "LEVEL_STATS_EVERY",
    "set_trace_sampling", "TRACE_SAMPLE_EVERY",
    "Counter", "Gauge", "Histogram", "Registry", "FlightRecorder",
    "Span", "SpanCtx", "NULL_SPAN",
    "assemble_trace", "trace_connected",
    "LATENCY_BUCKETS_S", "DEFAULT_BUCKETS",
    "export", "recorder", "registry", "trace",
]

# One gate shared by the registry, the tracer, and the recorder: a single
# bool attribute flip turns the whole plane on or off.
_GATE = _Gate(False)
REGISTRY = Registry(gate=_GATE)
RECORDER = FlightRecorder(gate=_GATE)
trace.GATE.on = False
trace.GATE.sink = RECORDER.record_span


def enabled() -> bool:
    return _GATE.on


def enable() -> None:
    _GATE.on = True
    trace.GATE.on = True


def disable() -> None:
    _GATE.on = False
    trace.GATE.on = False


def reset() -> None:
    """Clear all instruments, spans, and the recorder ring, and re-phase
    the descent-counter sample so the next dispatch accounts (tests,
    and short ``--obs`` runs that must populate the descent rows)."""
    global _level_stats_n
    REGISTRY.clear()
    RECORDER.reset()
    _level_stats_n = itertools.count()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str, buckets=LATENCY_BUCKETS_S) -> Histogram:
    return REGISTRY.histogram(name, buckets)


# High-rate trace roots (query tickets) are head-sampled: 1 in
# TRACE_SAMPLE_EVERY sampled=True roots gets a real span, so a 64-wide
# cohort carries ~8 ticket spans instead of 64.  Children of a traced
# root are always real; low-rate roots (mutations, replay) never sample.
TRACE_SAMPLE_EVERY = 8


def set_trace_sampling(every: int) -> None:
    """Set the head-sampling rate for ``sampled=True`` root spans: 1
    traces every root, N traces 1 in N.  Tests pin this to 1 so every
    ticket's trace is complete."""
    trace.GATE.sample_every = max(1, int(every))


def record_event(name: str, **attrs) -> None:
    RECORDER.record_event(name, **attrs)


def record_fault(name: str, exc: BaseException | None = None, **attrs):
    """Fault event + flight-recorder JSON dump (with a metrics snapshot
    attached).  No-op returning None when disabled."""
    if not _GATE.on:
        return None
    if exc is not None:
        attrs = dict(attrs, exc_type=type(exc).__name__, exc=str(exc))
    RECORDER.record_event(name, **attrs)
    return RECORDER.dump(reason=name, metrics=REGISTRY.snapshot())


# ------------------------------------------------- paper-level counters

# The paper-level descent counters are *sampled*: 1 in LEVEL_STATS_EVERY
# dispatches runs the level-stats descent variant (per-level pruned-by-
# bound reductions — a few percent per dispatch) and accounts queries /
# dist-evals / nodes / pruned; the other 15/16 run the default kernel
# and skip accounting entirely, including the device fetches for the
# reduction arrays.  Per-query averages (dist_evals_total /
# queries_total) stay unbiased because numerator and denominator are
# sampled together.  next() on itertools.count is atomic under the GIL.
LEVEL_STATS_EVERY = 16
_level_stats_n = itertools.count()


def want_level_stats() -> bool:
    """Should this dispatch run the level-stats variant and account the
    paper counters?  False when disabled; a 1/LEVEL_STATS_EVERY sample
    when enabled (the first dispatch after :func:`reset` always
    samples, so short runs still populate the descent rows)."""
    if not _GATE.on:
        return False
    return next(_level_stats_n) % LEVEL_STATS_EVERY == 0


def observe_query_result(res, pruned=None, *, prefix: str = "descent") -> None:
    """Accumulate the descent's per-dispatch reductions into paper-level
    counters: metric (distance) evaluations, nodes visited, and — when
    the kernel was asked for level stats — pruned-by-bound and
    pruned-by-parent per level.

    ``pruned`` is what ``smtree.knn(..., level_stats=True)`` returned:
    a ``(by_bound, by_parent)`` pair of ``[levels, b]`` stacks (a bare
    array is accepted as by-bound only, for older recorded shapes).
    ``by_parent`` feeds ``{prefix}.pruned_by_parent_total`` — entries the
    parent-distance pre-filter dropped before any metric eval, the
    quantity DESIGN.md §17 moves; note ``dist_evals_total`` already
    excludes them (it counts evaluations performed).

    ``res`` is the port's ``QueryResult`` (tensors on the tree's device):
    each field is reduced on its device and read back as one integer, a
    sync per field, paid only on the sampled dispatches.  Always check ``obs.enabled()`` before computing
    ``pruned`` — the level-stats kernel variant is a separate jit cache
    entry that should only ever compile with obs on."""
    if not _GATE.on:
        return
    b = int(res.dists.shape[0])
    dist_evals = int(res.dist_evals.sum())
    nodes = int(res.page_hits.sum())
    overflow = int(res.overflow.sum())
    REGISTRY.counter(f"{prefix}.queries_total").inc(b)
    REGISTRY.counter(f"{prefix}.dist_evals_total").inc(dist_evals)
    REGISTRY.counter(f"{prefix}.nodes_visited_total").inc(nodes)
    if overflow:
        REGISTRY.counter(f"{prefix}.frontier_overflow_total").inc(overflow)
    if pruned is None:
        return
    by_bound, by_parent = (pruned if isinstance(pruned, tuple)
                           else (pruned, None))
    for stack, kind in ((by_bound, "pruned_by_bound"),
                        (by_parent, "pruned_by_parent")):
        if stack is None:
            continue
        p = stack.cpu().numpy()         # [levels, b]
        REGISTRY.counter(f"{prefix}.{kind}_total").inc(int(p.sum()))
        for lvl in range(p.shape[0]):
            REGISTRY.counter(
                f"{prefix}.{kind}_level{lvl:02d}_total"
            ).inc(int(p[lvl].sum()))
