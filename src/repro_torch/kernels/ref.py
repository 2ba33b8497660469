"""Naive PyTorch oracles of the kernels (port of ``repro/kernels/ref.py``).

They materialise what the kernels avoid (the full logits, the full
difference tensor) and serve the tests as ground truth; no code path of
the port calls them.
"""
from __future__ import annotations

import torch


def pairwise_distance_ref(q, e, metric: str = "d_inf"):
    """[nq, d] x [ne, d] -> [nq, ne]: 'd_inf', 'l2', 'sqeuclidean' or 'ip'
    (negative inner product)."""
    q = q[:, None, :]
    e = e[None, :, :]
    if metric == "d_inf":
        return (q - e).abs().amax(-1)
    if metric in ("l2", "sqeuclidean"):
        d2 = ((q - e) ** 2).sum(-1)
        return d2.sqrt() if metric == "l2" else d2
    if metric == "ip":
        return -(q * e).sum(-1)
    raise ValueError(f"unknown metric {metric!r}")


def prune_mask_ref(dist, r_q, r_e):
    """Triangle-inequality survival mask: d(Q, O_n) <= r(Q) + r(O_n)."""
    return dist <= r_q[:, None] + r_e[None, :]


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        scale: float | None = None):
    """Multi-head GQA attention with the full softmax, in float32; returns
    q's dtype.  q: [b, h, sq, d]; k, v: [b, hk, sk, d]."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qf = q.float().reshape(b, hk, h // hk, sq, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(kpos <= qpos, logits, -torch.inf)
    w = torch.softmax(logits, -1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w, v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)
