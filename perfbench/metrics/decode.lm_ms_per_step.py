"""Host milliseconds of a decode step's model part (``make_decode_step``'s
function), from its start to a synchronise after it, averaged over the
counting third's steps."""


def read(sources):
    laps = (sources.get("counts") or {}).get("laps") or []
    ms = [lap["decode_ms"] for lap in laps]
    return None if not ms else sum(ms) / len(ms)
