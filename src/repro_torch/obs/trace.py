"""Structured trace spans with parent/child links and wall timings.

A copy of ``repro/obs/trace.py`` (which imports no JAX): the port keeps
its own, so that it imports nothing of the JAX package.

One ``trace_id`` threads a query ticket's life (admit → cohort assembly →
epoch pin → device compute → slice/reply) or a mutation batch's life
(WAL append → cohort cut → apply → split/merge → publish) across threads
and layers.  Span context propagates two ways:

* **explicitly** — tickets carry a ``SpanCtx`` so the dispatcher thread
  can parent cohort work on the submitting caller's trace, and
* **implicitly** — a thread-local "current span" lets deep callees
  (``StreamingEngine.apply`` internals, WAL append) attach to whatever
  span the calling thread has open, with zero plumbing.

Cohorts batch many tickets into one device dispatch, which is fan-*in*,
not fan-out: the cohort span is parented on one member ticket and
carries ``links`` — the trace_ids of every other member — so each
ticket's trace still reaches the shared device-compute span.

Disabled path: :func:`span` returns a shared no-op context manager and
:func:`start_span` returns a shared ``_NullSpan``; neither allocates,
takes a time reading, or touches the recorder.

Head sampling: span creation is the dominant obs cost on the serving
hot path (a cohort of 64 tickets is 64 root spans), so high-rate roots
opt in with ``sampled=True`` — only 1 in ``GATE.sample_every`` of those
calls creates a real span, the rest get ``NULL_SPAN``.  The decision is
made once at the root: children of a traced parent are always real, and
callers skip child creation when the root came back ``NULL_SPAN``.
Low-rate roots (mutation batches, replica replay, lease transitions)
never pass ``sampled`` and are always traced.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

__all__ = [
    "Span",
    "SpanCtx",
    "new_trace_id",
    "start_span",
    "span",
    "current_ctx",
    "assemble_trace",
    "trace_connected",
]

_tls = threading.local()


class _Gate:
    __slots__ = ("on", "sink", "sample_every")

    def __init__(self):
        self.on = False
        self.sink = None          # callable(Span) — set by obs/__init__
        self.sample_every = 8     # head-sampling rate for sampled=True roots


GATE = _Gate()
_sample_n = itertools.count()


# ids are a random per-process prefix + an atomic counter, not per-id
# os.urandom: a ticket span costs two ids, and at serving rates the
# urandom syscalls alone were a measurable slice of the cohort budget.
# (next() on itertools.count is atomic under the GIL.)
_ID_PREFIX = os.urandom(4).hex()
_ids = itertools.count()


def new_trace_id() -> str:
    return f"{_ID_PREFIX}{next(_ids) & 0xFFFFFFFF:08x}"


def _new_span_id() -> str:
    return f"{next(_ids) & 0xFFFFFFFF:08x}"


class SpanCtx:
    """Immutable (trace_id, span_id) pair that travels on tickets."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"SpanCtx({self.trace_id}/{self.span_id})"


class Span:
    __slots__ = ("trace_id", "span_id", "parent_id", "name",
                 "t_start", "t_end", "attrs", "links", "_done")

    def __init__(self, name: str, trace_id: str, parent_id: str | None,
                 links=(), attrs: dict | None = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.links = tuple(links)
        self.attrs = dict(attrs) if attrs else {}
        self.t_start = time.monotonic()
        self.t_end = None
        self._done = False

    @property
    def ctx(self) -> SpanCtx:
        return SpanCtx(self.trace_id, self.span_id)

    @property
    def duration_s(self) -> float:
        end = self.t_end if self.t_end is not None else time.monotonic()
        return end - self.t_start

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def end(self, **attrs) -> None:
        if self._done:
            return
        self._done = True
        if attrs:
            self.attrs.update(attrs)
        self.t_end = time.monotonic()
        sink = GATE.sink
        if sink is not None:
            sink(self)

    def to_dict(self) -> dict:
        return {
            "kind": "span",
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "duration_s": (self.t_end - self.t_start)
                          if self.t_end is not None else None,
            "links": list(self.links),
            "attrs": self.attrs,
        }


class _NullSpan:
    """Shared do-nothing span for the disabled path (and as a reusable
    no-op context manager).  Stateless, hence safe to share/re-enter."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None
    name = "null"
    links = ()
    attrs: dict = {}
    ctx = None
    duration_s = 0.0

    def set(self, **attrs):
        pass

    def end(self, **attrs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


def current_ctx() -> SpanCtx | None:
    """Ctx of the span the calling thread currently has open, if any."""
    cur = getattr(_tls, "current", None)
    return cur.ctx if cur is not None else None


def sample_root() -> bool:
    """One head-sampling decision, taken without building a span: True
    when a ``sampled=True`` root created right now would be real.  Lets
    per-ticket hot paths skip the ``start_span`` call (and its kwargs
    plumbing) entirely for the unsampled majority."""
    if not GATE.on:
        return False
    se = GATE.sample_every
    return se <= 1 or next(_sample_n) % se == 0


def start_span(name: str, *, parent: SpanCtx | None = None,
               trace_id: str | None = None, links=(), sampled: bool = False,
               **attrs):
    """Open a span (caller must ``end()`` it).  Parent resolution:
    explicit ``parent`` ctx > thread-local current span > new root.

    ``sampled=True`` marks a high-rate root: when the span *would* start
    a new trace (no parent, no explicit trace_id), only 1 in
    ``GATE.sample_every`` calls creates a real span; the rest return
    ``NULL_SPAN``.  Ignored when a parent is present — the root already
    made the decision."""
    if not GATE.on:
        return NULL_SPAN
    if parent is None:
        parent = current_ctx()
    if parent is None and sampled and trace_id is None:
        se = GATE.sample_every
        if se > 1 and next(_sample_n) % se:
            return NULL_SPAN
    if parent is not None:
        tid = trace_id if trace_id is not None else parent.trace_id
        pid = parent.span_id
    else:
        tid = trace_id if trace_id is not None else new_trace_id()
        pid = None
    return Span(name, tid, pid, links=links, attrs=attrs)


class _ActiveSpan:
    """Context manager installing a span as the thread-local current."""

    __slots__ = ("_span", "_prev")

    def __init__(self, s: Span):
        self._span = s
        self._prev = None

    def __enter__(self) -> Span:
        self._prev = getattr(_tls, "current", None)
        _tls.current = self._span
        return self._span

    def __exit__(self, exc_type, exc, tb):
        _tls.current = self._prev
        if exc_type is not None:
            self._span.attrs.setdefault("error", exc_type.__name__)
        self._span.end()
        return False


def span(name: str, *, parent: SpanCtx | None = None,
         trace_id: str | None = None, links=(), **attrs):
    """``with obs.span("wal.append", n=b):`` — opens a span, makes it the
    thread-local current (so nested spans parent on it), ends it on exit.
    Returns the shared no-op manager when tracing is off."""
    if not GATE.on:
        return NULL_SPAN
    return _ActiveSpan(start_span(name, parent=parent, trace_id=trace_id,
                                  links=links, **attrs))


# ---------------------------------------------------------------- analysis

def assemble_trace(records, trace_id: str) -> list[dict]:
    """Pick the span dicts belonging to ``trace_id`` out of a recorder
    dump/snapshot.  A span belongs if its trace_id matches *or* it links
    to the trace (cohort fan-in)."""
    out = []
    for r in records:
        if r.get("kind") != "span":
            continue
        if r.get("trace_id") == trace_id or trace_id in r.get("links", ()):
            out.append(r)
    return out


def trace_connected(records, trace_id: str) -> bool:
    """True when the trace's spans form one connected tree: exactly one
    root reachable from every span via parent edges (link-joined spans
    count as connected through the link)."""
    spans = assemble_trace(records, trace_id)
    if not spans:
        return False
    by_id = {s["span_id"]: s for s in spans}
    roots = 0
    for s in spans:
        pid = s.get("parent_id")
        if pid is None or pid not in by_id:
            # a span pulled in via links is attached through the link,
            # not a parent edge; only same-trace orphans count as roots
            if s.get("trace_id") == trace_id:
                roots += 1
    return roots == 1
