"""Milliseconds of the port's ``mutation.apply`` spans per mutation row,
over the spans that ended in the counting third."""


def read(sources):
    spans = [s for s in sources.get("spans") or [] if s.get("name") == "mutation.apply"
             and s.get("duration_s") is not None]
    rows = sum(s.get("attrs", {}).get("n", 0) for s in spans)
    return None if not rows else 1e3 * sum(s["duration_s"] for s in spans) / rows
