"""The narrow-row frontier kernel's share of its roofline: the bound of
each launch (the benchmark's frozen bytes and operations formula over the
pages the descent hands it, at 3.35 TB/s and 67 TFLOP/s) summed, over the
launches' device time, on cohorts of the cell's traffic replayed after
the window."""
from perfbench.metrics._device import roofline_share


def read(sources):
    return roofline_share(sources, "narrow")
