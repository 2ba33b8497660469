"""Flat-scan baseline of the SM-forest, on one device.

Port of ``repro/core/distributed.py:brute_force_knn`` (the paper's
"sequential scan" line and the oracle the tree is held against).  The
reference shards the scan over a mesh and merges per-shard top-k with an
all-gather; here it runs on one device (``device``: None = the card, as
for ``bulk_build``) through the distance kernel (kernels/distance.py).
The sharded form waits for the forest port.
"""
from __future__ import annotations

import torch

from repro_torch.core.smtree import resolve_device
from repro_torch.kernels.distance import pairwise_distance

# distances held at once: [b, chunk] f32 stays under 1 GiB
_SCAN_ELEMS = 1 << 28


def brute_force_knn(X, queries, *, k: int = 8, metric: str = "d_inf",
                    device=None):
    """Exact k-NN by a full scan: (dists [b, k] f32, ids [b, k] int64) on
    ``device`` (None = the card; it raises without one — pass
    ``device="cpu"`` to scan on the CPU).  ``X`` and ``queries`` (numpy or
    tensors on any device) are moved there.

    Equal distances come back lowest index first, as ``jax.lax.top_k``
    gives them (``torch.topk`` leaves ties unordered, so every selection is
    a stable sort).  When ``[b, n]`` distances do not fit at once the scan
    runs over chunks of entries and merges each chunk's top-k in chunk
    order, which keeps that tie order."""
    device = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=device)
    b, n = queries.shape[0], X.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, n={n}]; got {k}")
    step = max(k, _SCAN_ELEMS // max(1, b))
    best_d = best_i = None
    for s in range(0, n, step):
        d = pairwise_distance(queries, X[s:s + step], metric)
        kk = min(k, d.shape[1])
        vals, idx = torch.sort(d, dim=1, stable=True)
        vals, idx = vals[:, :kk], idx[:, :kk] + s
        if best_d is not None:
            vals = torch.cat([best_d, vals], dim=1)
            idx = torch.cat([best_i, idx], dim=1)
            vals, sel = torch.sort(vals, dim=1, stable=True)
            vals, idx = vals[:, :k], idx.gather(1, sel[:, :k])
        best_d, best_i = vals, idx
    return best_d, best_i
