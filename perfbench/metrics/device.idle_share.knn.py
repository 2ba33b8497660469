"""Percent of the profiled third of the window in which the card ran no
kernel (the union of the kernels' intervals, from the device trace)."""
from perfbench.metrics._device import idle_share


def read(sources):
    return idle_share(sources)
