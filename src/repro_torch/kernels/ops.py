"""Kernel entry points of the LM and the index (port of
``repro/kernels/ops.py``).

There is no ``impl`` switch: the tensors' device decides.  CPU tensors take
each kernel's plain PyTorch version, CUDA tensors launch the hand-written
kernel or raise.
"""
from __future__ import annotations

from repro_torch.kernels.distance import (pairwise_distance,
                                          pairwise_distance_prune)
from repro_torch.kernels.flash_attention import flash_attention_fwd

__all__ = ["attention", "pairwise_distance", "pairwise_distance_prune"]


def attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Multi-head GQA attention.  q: [b, h, sq, d]; k, v: [b, hk, sk, d].
    The flash kernel on the card, ``chunked_attention`` on the CPU."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)
