"""Brute-force k nearest neighbours and the replay of mutation rows."""
from __future__ import annotations

import numpy as np
import torch


def distances(X: torch.Tensor, Q: torch.Tensor, metric: str) -> torch.Tensor:
    """[q, n] distances of every query to every object, in the inputs'
    dtype: d_inf is max |q - x| (each difference rounded once, so it is
    exact for the inputs); l2 sums the squares in float64 and takes the
    root there."""
    if metric == "d_inf":
        return (Q[:, None, :] - X[None, :, :]).abs().amax(-1)
    if metric == "l2":
        Qd, Xd = Q.double(), X.double()
        sq = (Qd * Qd).sum(1)[:, None] + (Xd * Xd).sum(1)[None, :] - 2.0 * (Qd @ Xd.T)
        return sq.clamp_min(0).sqrt().to(Q.dtype)
    raise ValueError(metric)


def brute_force(X: torch.Tensor, Q: torch.Tensor, k: int, metric: str, *,
                block: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest distances of each query (ascending) and their row
    indices in ``X`` (equal distances: lowest row first), ``block``
    queries at a time so that it fits beside nothing else."""
    ds, ids = [], []
    for s in range(0, Q.shape[0], block):
        d = distances(X, Q[s:s + block], metric)
        v, i = torch.sort(d, dim=1, stable=True)
        ds.append(v[:, :k])
        ids.append(i[:, :k])
    return torch.cat(ds), torch.cat(ids)


def rows_distance(X: torch.Tensor, Q: torch.Tensor, rows: torch.Tensor, metric: str):
    """[q, k] distance of query i to row ``rows[i, j]`` of ``X`` (rows < 0:
    +inf)."""
    e = X[rows.clamp_min(0).long()]
    if metric == "d_inf":
        d = (Q[:, None, :] - e).abs().amax(-1)
    elif metric == "l2":
        d = ((Q[:, None, :].double() - e.double()) ** 2).sum(-1).sqrt().to(Q.dtype)
    else:
        raise ValueError(metric)
    return torch.where(rows >= 0, d, torch.full_like(d, float("inf")))


def compare_answers(X: torch.Tensor, Q: torch.Tensor, got_d: torch.Tensor,
                    got_rows: torch.Tensor, k: int, metric: str) -> dict:
    """Hold answers of an exact kNN (distances ``got_d`` [q, k] ascending,
    rows of ``X`` ``got_rows``) to the brute force.  ``dist_mismatch``:
    the (query, rank) pairs whose distance is not the brute force's bit
    for bit.  ``id_mismatch``: the pairs whose row is not at that rank's
    distance from the query, or repeats a row of its query (any row at
    the right distance is a right answer: ties may fall either way)."""
    ref_d, _ = brute_force(X, Q, k, metric)
    got_d = got_d.to(ref_d.device, ref_d.dtype)
    got_rows = got_rows.to(ref_d.device)
    dist_bad = (got_d != ref_d).sum().item()
    true_d = rows_distance(X, Q, got_rows, metric)
    srt = torch.sort(got_rows, dim=1).values
    dup = torch.zeros_like(got_rows, dtype=torch.bool)
    dup[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    id_bad = ((true_d != ref_d) | (got_rows < 0) | dup).sum().item()
    return {"dist_mismatch": int(dist_bad), "id_mismatch": int(id_bad)}


def replay(initial_ids: np.ndarray, tickets) -> set:
    """The live object ids after applying each acknowledged ticket's rows
    in order to ``initial_ids``: ``tickets`` yields (deleted ids, inserted
    ids).  A delete of an id that is not live, or an insert of one that
    is, raises: the traffic sends neither."""
    live = set(int(i) for i in initial_ids)
    for dels, ins in tickets:
        for o in dels:
            live.remove(int(o))
        for o in ins:
            o = int(o)
            if o in live:
                raise ValueError(f"insert of live id {o}")
            live.add(o)
    return live
