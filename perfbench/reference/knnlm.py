"""The kNN-LM mix (Khandelwal et al., arXiv:1911.00172) worked out from the
datastore's raw keys and values by brute force:

    p(w) = (1 - lam) p_LM(w) + lam p_kNN(w),
    p_kNN(w) = sum of softmax(-d / T) over the k nearest keys whose value is w,

with log p_kNN floored at log(1e-10), as the configuration serves it.
Distances are l2, summed in float64.
"""
from __future__ import annotations

import math

import torch


def knn_logp(keys64: torch.Tensor, values: torch.Tensor, h: torch.Tensor, cfg: dict,
             vocab: int, *, tie: float = 1e-5):
    """log p_kNN [q, V] (float64) of the queries ``h`` [q, D] over the
    keys (float64, [n, D]) and their values [n].  Also the same with the
    k-th neighbour swapped for the (k+1)-th, and the rows where those two
    lie within ``tie`` (relative) of each other: there either set is a
    right answer for a float32 descent."""
    k, T = cfg["knn_k"], cfg["temperature"]
    hq = h.double()
    sq = (hq * hq).sum(1)[:, None] + (keys64 * keys64).sum(1)[None, :] - 2.0 * hq @ keys64.T
    d, idx = torch.topk(sq.clamp_min(0), k + 1, dim=1, largest=False, sorted=True)
    d = d.sqrt()
    ambiguous = (d[:, k] - d[:, k - 1]) <= tie * d[:, k - 1]

    def logp(dd, ii):
        w = torch.softmax(-dd / T, -1)
        probs = torch.zeros((h.shape[0], vocab), dtype=torch.float64, device=h.device)
        probs.scatter_add_(1, values[ii].long(), w)
        return torch.log(probs.clamp_min(1e-10))

    main = logp(d[:, :k], idx[:, :k])
    alt_d = torch.cat([d[:, :k - 1], d[:, k:k + 1]], 1)
    alt_i = torch.cat([idx[:, :k - 1], idx[:, k:k + 1]], 1)
    return main, logp(alt_d, alt_i), ambiguous


def mix(lm_logits: torch.Tensor, knn_logp: torch.Tensor, lam: float) -> torch.Tensor:
    """log((1 - lam) p_LM + lam p_kNN), float64."""
    lm = torch.log_softmax(lm_logits.double(), -1)
    return torch.logaddexp(lm + math.log1p(-lam), knn_logp + math.log(lam))
