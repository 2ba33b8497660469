"""Split policies for (S)M-tree nodes — the PyTorch port's own copy of
``repro/core/split.py`` (numpy only; the port imports nothing of ``repro``),
used by the engine's host-side structure maintenance (core/engine.py).

``minmax_split`` is the original M-tree's mM_RAD promotion (try every pair of
entries as the promoted routing objects; minimise the larger covering radius)
with generalized-hyperplane distribution and a minimum-fill rebalance.
Vectorised over candidate pairs.

The paper (§5) notes SM-trees prefer tightly *centred* subtrees; we also ship
``central_split`` (promote the two entries with the smallest eccentricity,
then hyperplane-assign) as a cheaper SM-oriented policy — compared in
benchmarks/paper_queries.py.
"""
from __future__ import annotations

import numpy as np

__all__ = ["minmax_split", "central_split", "SPLIT_POLICIES", "min_side_for"]


def min_side_for(m: int, capacity: int, min_fill: int) -> int:
    """Minimum entries per side when splitting m entries into two nodes of
    ``capacity``.  The ``m - capacity`` term is load-bearing for delete
    re-splits (union of two nodes can reach ~1.4*capacity): it guarantees
    neither side overflows."""
    return max(2, min(min_fill, m // 2), m - capacity)


def _assign_and_radii(D, C, pi, pj):
    to_i = D[pi] <= D[pj]
    r_i = C[pi][to_i].max() if to_i.any() else 0.0
    r_j = C[pj][~to_i].max() if (~to_i).any() else 0.0
    return to_i, r_i, r_j


def _rebalance(D, pi, pj, side_i, side_j, min_side):
    side_i, side_j = list(side_i), list(side_j)
    while len(side_i) < min_side:
        mv = min(side_j, key=lambda k: D[pi, k])
        side_j.remove(mv); side_i.append(mv)
    while len(side_j) < min_side:
        mv = min(side_i, key=lambda k: D[pj, k])
        side_i.remove(mv); side_j.append(mv)
    return np.array(side_i), np.array(side_j)


def minmax_split(D: np.ndarray, child_radii: np.ndarray, is_leaf: bool,
                 min_side: int):
    """mM_RAD promotion + generalized hyperplane distribution.

    D: [m, m] pairwise distances between the m entries' reference values.
    child_radii: [m] covering radii of the entries (zeros for leaf entries).
    Returns (pi, pj, members_i, members_j, r_i, r_j) — promoted indices, the
    member index arrays (including the promoted entries themselves) and the
    covering radii of the two routing entries.

    All m(m-1)/2 candidate pairs are scored in one vectorised pass
    (``np.argmin`` keeps the first minimal pair, matching the original
    lexicographic loop's strict-< tie-breaking exactly); this is the stream
    batcher's escalation hot path, where the per-pair Python loop dominated
    sustained mutation throughput.
    """
    m = D.shape[0]
    C = D if is_leaf else D + np.asarray(child_radii)[None, :]
    ii, jj = np.triu_indices(m, k=1)
    to_i = D[ii] <= D[jj]                           # [P, m]: hyperplane side
    r_i = np.where(to_i, C[ii], -np.inf).max(axis=1)
    r_j = np.where(to_i, -np.inf, C[jj]).max(axis=1)
    r_i = np.where(np.isfinite(r_i), r_i, 0.0)      # empty side covers 0
    r_j = np.where(np.isfinite(r_j), r_j, 0.0)
    best = int(np.argmin(np.maximum(r_i, r_j)))
    pi, pj, to_i = int(ii[best]), int(jj[best]), to_i[best]
    idx = np.arange(m)
    side_i, side_j = _rebalance(D, pi, pj, idx[to_i], idx[~to_i], min_side)
    r_i = float(C[pi, side_i].max())
    r_j = float(C[pj, side_j].max())
    return pi, pj, side_i, side_j, r_i, r_j


def central_split(D: np.ndarray, child_radii: np.ndarray, is_leaf: bool,
                  min_side: int):
    """SM-oriented O(m^2) policy: promote the two lowest-eccentricity entries
    that are not too close to each other, hyperplane-assign, rebalance."""
    m = D.shape[0]
    C = D if is_leaf else D + np.asarray(child_radii)[None, :]
    ecc = C.max(axis=1)                       # eccentricity of each candidate
    order = np.argsort(ecc)
    pi = int(order[0])
    # second promoter: low eccentricity but far from pi (avoid twin centres)
    score = ecc + 1e-3 - 0.5 * D[pi]
    score[pi] = np.inf
    pj = int(np.argmin(score))
    to_i, _, _ = _assign_and_radii(D, C, pi, pj)
    idx = np.arange(m)
    side_i, side_j = _rebalance(D, pi, pj, idx[to_i], idx[~to_i], min_side)
    r_i = float(C[pi, side_i].max())
    r_j = float(C[pj, side_j].max())
    return pi, pj, side_i, side_j, r_i, r_j


SPLIT_POLICIES = {"minmax": minmax_split, "central": central_split}
