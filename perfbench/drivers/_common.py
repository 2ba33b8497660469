"""Pieces the drivers share: freeing the program's state before the
reference runs, and timing the frontier kernel against its roofline."""
from __future__ import annotations

import gc

from perfbench import roofline


def free_device(on_card: bool) -> None:
    """Return the program's freed device memory before the reference
    runs (the process's peak was read already)."""
    gc.collect()
    if on_card:
        import torch
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class FrontierMeter:
    """A scorer for the port's private ``_scorer`` hook: it calls the
    port's own ``frontier_scores`` (the kernel on the card) and adds up
    the bound of each launch from the benchmark's frozen formula.  Used
    after the window, under the profiler, so the counting's extra device
    work reaches neither the window nor the kernel's own time."""

    def __init__(self):
        from repro_torch.kernels.frontier import frontier_scores
        self._fs = frontier_scores
        self.bound_s = 0.0

    def __call__(self, fids, queries, vecs, radius, internal_valid, leaf_valid, *, metric,
                 pdist=None, qpd=None, rq=None):
        outs = self._fs(fids, queries, vecs, radius, internal_valid, leaf_valid,
                        metric=metric, pdist=pdist, qpd=qpd, rq=rq)
        ops, nbytes = roofline.frontier_work(fids, queries, outs, vecs.shape[1],
                                             pdist is not None)
        self.bound_s += roofline.bound_s(ops, nbytes)
        return outs


def frontier_roofline(fn, kernel: str, on_card: bool) -> dict | None:
    """Run ``fn(meter)`` under the profiler; return the summed bound and
    the device time of the launches of ``kernel`` (a substring of the
    kernel's name), or None off the card."""
    if not on_card:
        return None
    from perfbench.profiling import DeviceTrace
    meter = FrontierMeter()
    dt = DeviceTrace()
    dt.start()
    fn(meter)
    s = dt.stop()
    dev = [v for name, v in s["kernels"].items() if kernel in name]
    return {"bound_s": meter.bound_s, "device_s": sum(v[0] for v in dev)}
