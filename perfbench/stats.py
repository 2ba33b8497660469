"""Tail, spread and rate arithmetic of the benchmark."""
from __future__ import annotations

import statistics


def percentile(values, pct: float) -> float:
    """The ``pct``-th percentile of all ``values`` (inclusive linear
    interpolation between order statistics, as numpy's default and
    ``statistics.quantiles(method="inclusive")`` give it)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    if len(xs) == 1:
        return float(xs[0])
    h = (len(xs) - 1) * pct / 100.0
    lo = int(h)
    hi = min(lo + 1, len(xs) - 1)
    return float(xs[lo] + (h - lo) * (xs[hi] - xs[lo]))


def spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``, its default method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def interpolated_rate(acks, t_open: float, t_close: float, t_start: float) -> float:
    """Work per second over exactly ``[t_open, t_close]`` for a serial
    server that completes items of known size one after another.

    ``acks`` is the ordered list of ``(t_ack, n)``: item ``i`` was served
    over ``[t_ack[i-1], t_ack[i]]`` (the first one from ``t_start``) and its
    ``n`` units count in proportion to the part of that interval inside the
    window.  So every unit of work done in the window counts, an item cut
    by either edge counts in part, and the rate takes all of the window's
    time.  Items whose service ends after ``t_close`` must be in ``acks``
    (the caller waits for them)."""
    if t_close <= t_open:
        raise ValueError("empty window")
    done = 0.0
    prev = t_start
    for t_ack, n in acks:
        a, b = max(prev, t_open), min(t_ack, t_close)
        if b > a and t_ack > prev:
            done += n * (b - a) / (t_ack - prev)
        prev = t_ack
    if prev < t_close:
        raise ValueError("the acks end before the window closes")
    return done / (t_close - t_open)
