"""The serving front-end's read path over one pinned epoch.

Port of ``pinned_knn`` from ``repro/serve/frontend.py``, shared by the
streaming forest (``StreamingForest.knn``) and the kNN-LM store's stream
path.  The rest of the front-end (the admission queue, cohort assembly,
the mutation scheduler) is not ported yet: ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core import smtree

__all__ = ["pinned_knn"]


def pinned_knn(pinned, queries, *, k: int, max_frontier: int, _scorer=None):
    """kNN over one pinned epoch: a single tree, or a tuple of forest
    shards (per-shard cohort descent, then the top-k of the shard-major
    candidates by a stable sort: equal distances keep the lowest shard,
    then the lowest rank, as the reference's ``np.argsort(kind="stable")``
    does).  Returns (dists [b, k] f32, ids [b, k] int32) on the shards'
    device.

    With observability on, a 1/``obs.LEVEL_STATS_EVERY`` sample of
    dispatches runs the level-stats descent and accumulates the paper
    counters (queries, distance evals, nodes visited, pruned per level).
    ``_scorer`` is private, as in ``smtree.knn``: it replaces the frontier
    scorer, so a caller can hold the kernel against the plain version."""
    if not isinstance(pinned, (tuple, list)):
        pinned = (pinned,)
    on = obs.enabled()
    ds, ids = [], []
    for t in pinned:
        if on and obs.want_level_stats():
            res, pruned = smtree.knn(t, queries, k=k,
                                     max_frontier=max_frontier,
                                     level_stats=True, _scorer=_scorer)
            obs.observe_query_result(res, pruned)
        else:
            res = smtree.knn(t, queries, k=k, max_frontier=max_frontier,
                             _scorer=_scorer)
        ds.append(res.dists)
        ids.append(res.ids)
    d, sel = smtree._smallest(torch.cat(ds, dim=1), k)
    return d, torch.cat(ids, dim=1).gather(1, sel)
