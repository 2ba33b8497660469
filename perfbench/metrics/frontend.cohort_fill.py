"""Mean real rows per dispatched cohort: the front end's gauge
``frontend.mean_cohort_fill``, read at the end of the counting third."""


def read(sources):
    v = (sources.get("obs") or {}).get("frontend.mean_cohort_fill")
    return None if not v else float(v)
