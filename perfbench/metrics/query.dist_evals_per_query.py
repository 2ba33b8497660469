"""Metric evaluations per query of the cohort descent: the port's sampled
level-stats counters ``descent.dist_evals_total`` over
``descent.queries_total`` (numerator and denominator sampled together),
counted over the counting third."""


def read(sources):
    m = sources.get("obs") or {}
    q = m.get("descent.queries_total")
    return None if not q else m["descent.dist_evals_total"] / q
