"""Readings of the traced run's device trace that several metrics share."""


def idle_share(sources) -> float | None:
    """Percent of the profiled phase in which no kernel ran on the card."""
    tr = sources.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline_share(sources, family: str) -> float | None:
    """Percent of its roofline that the frontier kernel's launches reach
    over the post-window replay: their summed bound over their summed
    device time."""
    r = (sources.get("roofline") or {}).get(family)
    if not r or r["device_s"] <= 0 or r["bound_s"] <= 0:
        return None
    return 100.0 * r["bound_s"] / r["device_s"]
