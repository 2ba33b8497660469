"""Attention in plain PyTorch: the online-softmax chunked form and decode.

Port of ``repro/kernels/attention_xla.py``.  ``chunked_attention`` is the
flash kernel's math as a loop over key chunks with a running max, running
sum and rescaled accumulator (memory O(sq * chunk) per head instead of
O(sq * sk)); it is the plain version of ``csrc/flash_attention.cu``.
``decode_attention`` is the one-position attention of cached decoding; the
JAX package has no kernel for it, so it stays plain PyTorch on every
device.  Both compute in float32 and return the query's dtype; masked
logits are ``NEG_INF`` (-1e30), never -inf.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def chunked_attention(q, k, v, *, causal: bool = True,
                      scale: float | None = None, chunk: int = 512):
    """q: [b, h, sq, d]; k, v: [b, hk, sk, d] with h % hk == 0 (GQA).
    Causal masking is bottom-right aligned: query i sees keys
    ``j <= i + (sk - sq)``.  Keys are zero-padded to a multiple of
    ``chunk`` and the padding masked, as in the reference."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = h // hk
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    qf = (q.float() * scale).reshape(b, hk, g * sq, d)   # group folded into rows
    qpos = (torch.arange(sq, device=dev) + (sk - sq)).repeat(g)      # [g*sq]

    chunk = min(chunk, sk)
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))

    m = torch.full((b, hk, g * sq, 1), NEG_INF, device=dev)
    l = torch.zeros((b, hk, g * sq, 1), device=dev)
    acc = torch.zeros((b, hk, g * sq, d), device=dev)
    for j in range(n_chunks):
        kc = kf[:, :, j * chunk:(j + 1) * chunk]
        vc = vf[:, :, j * chunk:(j + 1) * chunk]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kc)       # [b, hk, g*sq, chunk]
        kpos = j * chunk + torch.arange(chunk, device=dev)
        mask = (kpos < sk)[None, :]
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, vc)
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.reshape(b, hk, g, sq, d).reshape(b, h, sq, d).to(q.dtype)


def decode_attention(q1, k, v, *, scale: float | None = None, kv_len=None,
                     positions=None, merge=None):
    """Single-position decode attention.

    q1: [b, h, 1, d]; k, v: [b, hk, S, d] (the cache, possibly longer than
    the valid prefix); kv_len: [b] valid lengths (attend to positions
    < kv_len).  GQA folds the query group instead of repeating the cache.
    Safe softmax in float32.

    For a cache that holds one slice of the sequence (dist/parallel.py):
    ``positions`` [S] are its slots' positions (default ``arange(S)``), and
    ``merge(t, op)`` combines a partial result in place over the ranks that
    hold the other slices, ``op`` "max" for the running max and "sum" for
    the softmax's sum and the weighted values (a log-sum-exp merge)."""
    b, h, _, d = q1.shape
    hk, S = k.shape[1], k.shape[2]
    g = h // hk
    scale = d ** -0.5 if scale is None else scale
    qf = q1.float().reshape(b, hk, g, d) * scale
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k.float())
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q1.device)
        if positions is None:
            positions = torch.arange(S, device=q1.device)
        mask = positions[None, :] < kv_len[:, None]                    # [b, S]
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    if merge is not None:
        merge(m, "max")
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    if merge is not None:
        merge(l, "sum")
        merge(acc, "sum")
    out = acc / torch.where(l == 0, 1.0, l)
    return out.reshape(b, h, 1, d).to(q1.dtype)
