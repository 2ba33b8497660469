"""Percent of mutation rows escalated to the host plane: the port's
counters ``stream.escalated_rows_total`` over ``stream.rows_total`` in the
counting third."""


def read(sources):
    m = sources.get("obs") or {}
    rows = m.get("stream.rows_total")
    return None if not rows else 100.0 * m.get("stream.escalated_rows_total", 0) / rows
