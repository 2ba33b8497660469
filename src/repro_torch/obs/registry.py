"""Lock-cheap metrics registry: counters, gauges, fixed-bucket histograms.

A copy of ``repro/obs/registry.py`` (which imports no JAX): the port keeps
its own, so that it imports nothing of the JAX package.

Design constraints (DESIGN.md §15):

* **Near-zero when disabled.**  Every instrument handed out by the global
  registry shares one module-level gate; the hot-path methods start with a
  single attribute check (``if not self._gate.on: return``) and touch
  nothing else.  No locks, no allocation, no time calls on the disabled
  path.
* **Bounded memory.**  Histograms are fixed bucket arrays (counts +
  count/sum/min/max) — never unbounded sample lists.  Percentiles come
  from a cumulative walk over the bucket table, so p50/p95/p99 are
  bucket-upper-bound estimates with relative error set by the bucket
  geometry (~2x steps by default).
* **Lock-cheap, not lock-free.**  Each instrument owns its own small
  ``threading.Lock``; contention is per-metric, and the critical sections
  are a handful of integer ops.  CPython's GIL already serialises the
  int increments — the locks exist so ``snapshot()`` reads are coherent
  and the code stays correct on free-threaded builds.

Instruments constructed *directly* (``Histogram("x", buckets)``) are
always-on — that is the migration path for ``FrontendStats``, whose
latency percentiles must keep working with observability off because the
bench gate reads them.  Instruments obtained through :func:`Registry
.counter` / ``gauge`` / ``histogram`` inherit the registry's gate.
"""

from __future__ import annotations

import math
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "LATENCY_BUCKETS_S",
    "DEFAULT_BUCKETS",
]

_INF = float("inf")

# ~2x geometric ladder from 100 us to ~100 s: right-sized for request
# latencies (sub-ms cohort waits up to multi-second chaos drills).
LATENCY_BUCKETS_S = tuple(1e-4 * (2.0 ** i) for i in range(21))

# General-purpose magnitude ladder for dimensionless observations.
DEFAULT_BUCKETS = tuple(10.0 ** e for e in range(-4, 8))


class _Gate:
    """Shared on/off switch.  One attribute read on the hot path."""

    __slots__ = ("on",)

    def __init__(self, on: bool = False):
        self.on = on


_ALWAYS_ON = _Gate(True)


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "_gate", "_lock", "_value")

    def __init__(self, name: str, *, gate: _Gate | None = None):
        self.name = name
        self._gate = gate if gate is not None else _ALWAYS_ON
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        if not self._gate.on:
            return
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def snapshot(self):
        return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_gate", "_lock", "_value")

    def __init__(self, name: str, *, gate: _Gate | None = None):
        self.name = name
        self._gate = gate if gate is not None else _ALWAYS_ON
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        if not self._gate.on:
            return
        with self._lock:
            self._value = v

    @property
    def value(self):
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0

    def snapshot(self):
        return self._value


class Histogram:
    """Fixed-bucket histogram with count/sum/min/max and percentile reads.

    ``buckets`` is an ascending tuple of upper bounds; an implicit +inf
    bucket catches the overflow.  ``observe`` is O(log n_buckets) via
    binary search; memory is O(n_buckets) forever.
    """

    __slots__ = ("name", "buckets", "_gate", "_lock", "_counts",
                 "_count", "_sum", "_min", "_max")

    def __init__(self, name: str, buckets=LATENCY_BUCKETS_S, *,
                 gate: _Gate | None = None):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError("buckets must be a non-empty ascending sequence")
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        self._gate = gate if gate is not None else _ALWAYS_ON
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +1: the +inf bucket
        self._count = 0
        self._sum = 0.0
        self._min = _INF
        self._max = -_INF

    def _bucket_index(self, v: float) -> int:
        lo, hi = 0, len(self.buckets)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def observe(self, v: float) -> None:
        if not self._gate.on:
            return
        v = float(v)
        if math.isnan(v):
            return
        i = self._bucket_index(v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def observe_many(self, vs) -> None:
        for v in vs:
            self.observe(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, pct: float) -> float:
        """Upper-bound estimate of the ``pct``-th percentile.

        Returns the upper bound of the bucket where the cumulative count
        crosses ``pct`` — exact max for the overflow bucket.
        """
        with self._lock:
            total = self._count
            if total == 0:
                return 0.0
            target = max(1, math.ceil(total * pct / 100.0))
            seen = 0
            for i, c in enumerate(self._counts):
                seen += c
                if seen >= target:
                    if i < len(self.buckets):
                        # clamp to the observed max: a single sample in a
                        # wide bucket should not report the bucket ceiling
                        return min(self.buckets[i], self._max)
                    return self._max
            return self._max  # pragma: no cover

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._count = 0
            self._sum = 0.0
            self._min = _INF
            self._max = -_INF

    def full_snapshot(self):
        base = {
            "count": self._count,
            "sum": self._sum,
            "min": self._min if self._count else 0.0,
            "max": self._max if self._count else 0.0,
        }
        base["p50"] = self.percentile(50)
        base["p95"] = self.percentile(95)
        base["p99"] = self.percentile(99)
        return base


class Registry:
    """Named instrument table.  ``counter``/``gauge``/``histogram`` are
    get-or-create, so any module can say
    ``obs.counter("wal.appends_total")`` and share the process-wide
    instrument without plumbing handles around."""

    def __init__(self, *, gate: _Gate | None = None):
        self._gate = gate if gate is not None else _Gate(True)
        self._lock = threading.Lock()
        self._instruments: dict[str, object] = {}

    @property
    def enabled(self) -> bool:
        return self._gate.on

    def enable(self) -> None:
        self._gate.on = True

    def disable(self) -> None:
        self._gate.on = False

    def _get_or_create(self, name, kind, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = factory()
                self._instruments[name] = inst
            elif not isinstance(inst, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {kind.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get_or_create(
            name, Counter, lambda: Counter(name, gate=self._gate))

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(
            name, Gauge, lambda: Gauge(name, gate=self._gate))

    def histogram(self, name: str, buckets=LATENCY_BUCKETS_S) -> Histogram:
        return self._get_or_create(
            name, Histogram, lambda: Histogram(name, buckets, gate=self._gate))

    def register(self, inst) -> None:
        """Adopt an externally-constructed instrument (typically an
        always-on one like ``FrontendStats.latency_hist``) so snapshots
        include it — instead of double-observing every sample into a
        second registry-gated copy.  Last registration wins, so after a
        ``clear()`` (or a newer front-end claiming the name) the active
        instrument is the one exported."""
        with self._lock:
            self._instruments[inst.name] = inst

    def get(self, name: str):
        return self._instruments.get(name)

    def names(self):
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> dict:
        """Flat ``{name: value}`` dict; histograms expand to
        ``name.count`` / ``name.sum`` / ``name.p50`` / … rows."""
        with self._lock:
            items = list(self._instruments.items())
        out: dict[str, float] = {}
        for name, inst in sorted(items):
            if isinstance(inst, Histogram):
                for k, v in inst.full_snapshot().items():
                    out[f"{name}.{k}"] = v
            else:
                out[name] = inst.snapshot()
        return out

    def reset(self) -> None:
        with self._lock:
            items = list(self._instruments.values())
        for inst in items:
            inst.reset()

    def clear(self) -> None:
        with self._lock:
            self._instruments.clear()
