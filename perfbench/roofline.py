"""The benchmark's own yardstick: the H100's published peaks, the frontier
kernel's operations and bytes, and the decode step's model FLOPs.

Frozen copies: the program may change its own formulas
(``repro_torch/roofline/counts.py:frontier_work``,
``repro_torch/roofline/analysis.py``), and a later change may not move
the yardstick it is measured with.
"""
from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit.
H100_BYTES_PER_S = 3.35e12        # HBM3
H100_F32_FLOP_PER_S = 67e12       # float32 outside the tensor cores
H100_TF32_FLOP_PER_S = 495e12
H100_BF16_FLOP_PER_S = 989e12


def frontier_work(fids, queries, outs, cap: int, prune: bool) -> tuple[float, float]:
    """(operations, bytes) of one frontier scoring on this data: the
    frontier ids and the queries read once, each distinct page the
    descent hands the kernel read once for its radius, validity bits
    (and parent distances when pruned), each distinct live entry's vector
    read once, the four ``[b, F, cap]`` f32 outputs written once; 3
    operations per dimension of a live (scored) entry and 4 per output
    slot.  ``outs`` are the kernel's outputs: an entry is live where its
    ``dmax`` or ``leaf_d`` output is finite."""
    b, F = fids.shape
    dim = queries.shape[1]
    live = torch.isfinite(outs[0]) | torch.isfinite(outs[2])
    n_live = int(live.sum())
    nodes = fids.clamp(min=0).long()
    entry = nodes[:, :, None] * cap + torch.arange(cap, device=fids.device)
    n_vec_rows = torch.unique(entry[live]).numel()
    n_pages = torch.unique(nodes[fids >= 0]).numel()
    per_page = cap * (4 + 1 + 1 + (4 if prune else 0))
    nbytes = (fids.numel() * 4 + queries.numel() * 4
              + n_pages * per_page + n_vec_rows * dim * 4
              + (b * F * 4 + b * 4 if prune else 0)
              + 4 * b * F * cap * 4)
    return float(n_live * dim * 3 + 4 * b * F * cap), float(nbytes)


def bound_s(ops: float, nbytes: float, flop_per_s: float = H100_F32_FLOP_PER_S) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the HBM bandwidth."""
    return max(ops / flop_per_s, nbytes / H100_BYTES_PER_S)


def decode_flops_per_token(cfg: dict, context: int) -> float:
    """Model FLOPs of one token through a dense GQA decoder with a 2-matrix
    MLP at its published sizes (``cfg``: the configuration file's keys),
    attending over ``context`` cached positions: 2 per weight of every
    matrix product (the attention projections, the MLP, the LM head; the
    embedding lookup is no product) and 4 per head dimension and position
    of the attention scores and values."""
    D, L = cfg["d_model"], cfg["n_layers"]
    H, KV, F, V = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"], cfg["vocab_size"]
    dh = D // H
    per_layer = D * H * dh + 2 * D * KV * dh + H * dh * D + 2 * D * F
    return 2.0 * (L * per_layer + D * V) + 4.0 * L * H * dh * context
