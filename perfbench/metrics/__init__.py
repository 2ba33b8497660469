"""One reader per per-layer metric, ``<metric name>.py``, found by the name
in ``BENCHMARK.json``.  ``read(sources)`` takes what a traced run gathered
(the port's counters and spans, the device trace, the driver's counts)
and returns the metric, or None where it finds nothing to read: the
harness then leaves the metric out of the line."""
