"""Device trace of a traced run's profiled phase (torch.profiler, CUPTI).

Everything is read from kineto's raw events: ``key_averages()`` builds a
tree of host events that takes minutes at 10^6 events.  Busy time is the
union of the kernels' intervals (a kernel that overlaps another counts
once); idle gaps are the parts of the profiled phase that no kernel
covers, each named after the innermost host event that spans its middle.
"""
from __future__ import annotations

import time

import numpy as np
import torch


class DeviceTrace:
    """``start()`` ... ``stop()`` around the profiled phase; ``stop()``
    returns the reduction (``summary``).  The phase's edges are read from
    the host's clock in kineto's time base (Unix nanoseconds)."""

    def __init__(self):
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        kw = {}
        try:    # host ops of every thread, where this torch has the switch
            from torch._C._profiler import _ExperimentalConfig
            kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            pass
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kw)
        self._prof.__enter__()
        self.w0 = time.time_ns()

    def stop(self) -> dict:
        torch.cuda.synchronize()
        w1 = time.time_ns()
        self._prof.__exit__(None, None, None)
        events = list(self._prof.profiler.kineto_results.events())
        self._prof = None
        return summary(events, self.w0, w1)


def warm_up() -> None:
    """One short profiled span, so that the profiler's first start in the
    process (CUPTI's set-up) falls in the run's set-up, not in its
    window."""
    dt = DeviceTrace()
    dt.start()
    torch.zeros(1, device="cuda").add_(1)
    dt.stop()


def _is_device(ev) -> bool:
    return "CUDA" in str(ev.device_type())


def summary(events, w0: int, w1: int) -> dict:
    """busy_s, window_s, kernels ({name: [seconds, launches]}), and the
    breakdown's ``device_ops`` and ``idle_gaps`` (at most 10 each) of the
    phase ``[w0, w1]`` (ns)."""
    kern = [e for e in events if _is_device(e) and not e.is_user_annotation()]
    host = [e for e in events if not _is_device(e)]
    by_name: dict[str, list] = {}
    iv = []
    for e in kern:
        a, d = e.start_ns(), e.duration_ns()
        slot = by_name.setdefault(e.name(), [0.0, 0])
        slot[0] += d / 1e9
        slot[1] += 1
        iv.append((max(a, w0), min(a + d, w1)))
    iv = sorted((a, b) for a, b in iv if b > a)
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_ns = sum(b - a for a, b in merged)
    gaps, prev = [], w0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return dict(busy_s=busy_ns / 1e9, window_s=(w1 - w0) / 1e9,
                kernels={k: v for k, v in by_name.items()},
                device_ops=[[k, v[0]] for k, v in ops[:10]],
                idle_gaps=_name_gaps(gaps, host))


def _name_gaps(gaps, host, longest: int = 500) -> list:
    """The idle time of the ``longest`` gaps, summed by the innermost host
    event spanning each gap's middle (``host: none recorded`` where no
    host event does); the 10 largest sums."""
    if not gaps:
        return []
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
    if host:
        st = np.array([e.start_ns() for e in host], np.int64)
        du = np.array([e.duration_ns() for e in host], np.int64)
        names = [e.name() for e in host]
    sums: dict[str, float] = {}
    for a, b in gaps:
        name = "host: none recorded"
        if host:
            mid = (a + b) // 2
            hit = np.nonzero((st <= mid) & (st + du >= mid))[0]
            if len(hit):
                name = names[hit[np.argmin(du[hit])]]
        sums[name] = sums.get(name, 0.0) + (b - a) / 1e9
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:10]]
