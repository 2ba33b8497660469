"""GQA attention block: full-sequence forward (the flash kernel) and cached
decode.  Port of ``repro/models/attention.py``.

Projection weights keep the reference's head-shaped layout (``wq`` [D, H,
dh], ``wk``/``wv`` [D, KV, dh], ``wo`` [H, dh, D], optional QKV bias), so a
JAX parameter tree converts leaf for leaf.  ``attn_apply`` repeats K/V to
the query heads as the reference does (``attention.py:81-84``) and calls
``kernels.ops.attention``: the hand-written flash kernel for CUDA tensors,
its plain version for CPU tensors.  ``attn_decode`` writes the new
position into the cache with a masked (elementwise) write and attends with
``decode_attention``, which stays plain PyTorch (the JAX package has no
kernel for it).  Padded query heads (``head_pad``) are zeroed at the
output, so padding is exactly inert.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.dist.collectives import all_gather
from repro_torch.dist.tp import ONE
from repro_torch.kernels import ops
from repro_torch.kernels.attention_plain import decode_attention
from repro_torch.models.layers import _frozen, apply_rope, truncated_normal


class Attention(nn.Module):
    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(_frozen, (wq, wk, wv, wo))
        self.bq, self.bk, self.bv = (None if t is None else _frozen(t)
                                     for t in (bq, bk, bv))

    @classmethod
    def init(cls, cfg, dtype, *, generator, device=None):
        D, dh = cfg.d_model, cfg.d_head
        H, KV = cfg.padded_heads, cfg.padded_kv_heads
        tn = lambda shape, scale: truncated_normal(
            shape, scale, dtype, generator=generator, device=device)
        scale = D ** -0.5
        w = [tn((D, H, dh), scale), tn((D, KV, dh), scale),
             tn((D, KV, dh), scale), tn((H, dh, D), (H * dh) ** -0.5)]
        b = []
        if cfg.qkv_bias:
            z = lambda n: torch.zeros((n, dh), dtype=dtype, device=w[0].device)
            b = [z(H), z(KV), z(KV)]
        return cls(*w, *b)


def _head_mask(cfg, out, lo: int = 0):
    """Zero the padded q-heads (axis 1 of [b, H, s, dh]); ``out`` holds
    heads ``lo, lo + 1, ...`` (a tensor-parallel rank's slice)."""
    if cfg.padded_heads == cfg.n_heads:
        return out
    idx = torch.arange(out.shape[1], device=out.device)
    mask = ((idx + lo if lo else idx) < cfg.n_heads).to(out.dtype)
    return out * mask[None, :, None, None]


def _project_qkv(p: Attention, cfg, x, pos, tp=ONE, sharded: bool = False):
    """x: [b, s, D] -> q [b, H, s, dh] (this rank's heads where ``wq`` is
    split), k/v [b, KV, s, dh] (replicated, through copy-to in a sharded
    layer)."""
    wk, wv = tp.rep(p.wk, sharded), tp.rep(p.wv, sharded)
    q = torch.einsum("bsd,dhe->bhse", x, p.wq.to(x.dtype))
    k = torch.einsum("bsd,dhe->bhse", x, wk.to(x.dtype))
    v = torch.einsum("bsd,dhe->bhse", x, wv.to(x.dtype))
    if p.bq is not None:
        q = q + p.bq.to(x.dtype)[None, :, None, :]
        k = k + tp.rep(p.bk, sharded).to(x.dtype)[None, :, None, :]
        v = v + tp.rep(p.bv, sharded).to(x.dtype)[None, :, None, :]
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, pos[:, None, :], cfg.rope_theta)
        k = apply_rope(k, pos[:, None, :], cfg.rope_theta)
    return q, k, v


def _out_proj(p: Attention, out):
    """out: [b, H, s, dh] -> [b, s, D]."""
    return torch.einsum("bhse,hed->bsd", out, p.wo.to(out.dtype))


def _repeat_kv(t, g: int):
    """[b, KV, s, dh] -> [b, KV * g, s, dh], each head ``g`` times in a row
    (``repeat_interleave``'s order) through a broadcast, whose backward is
    a sum over the copies rather than an accumulating scatter."""
    b, kv, s, dh = t.shape
    return t[:, :, None].expand(b, kv, g, s, dh).reshape(b, kv * g, s, dh)


def attn_apply(p: Attention, cfg, x, *, pos, attention=None, tp=None):
    """Full-sequence causal attention.  x: [b, s, D]; pos: [b, s].
    ``attention`` replaces ``ops.attention`` (the plain version on the card,
    for comparisons); None takes the device's default.  On a mesh
    (``tp``, dist/tp.py) ``p`` may hold this rank's query heads ``lo, lo +
    1, ...`` (``wq``, ``bq`` and ``wo`` on their head axis; ``wk``/``wv``
    whole): the K/V repeated to every head are then cut to the same heads,
    and the row-parallel output leaves through ``tp.leave``."""
    tp = tp or ONE
    sh = tp.sharded(p)
    x = tp.enter(x, sh)
    q, k, v = _project_qkv(p, cfg, x, pos, tp, sh)
    lo = tp.lo(q.shape[1], sh)
    g = cfg.padded_heads // cfg.padded_kv_heads
    if g > 1:
        k, v = _repeat_kv(k, g), _repeat_kv(v, g)
    if q.shape[1] != k.shape[1]:
        k, v = k[:, lo:lo + q.shape[1]], v[:, lo:lo + q.shape[1]]
    out = (attention or ops.attention)(q, k, v, causal=True)
    return tp.leave(_out_proj(p, _head_mask(cfg, out, lo)), sh)


def decode_heads(q, k, v, tp, sharded: bool, *, kv_len=None, positions=None, merge=None):
    """One position's attention of this rank's query heads q [b, h, 1, dh]
    over the cache k/v [b, KV, S, dh], which may hold one slice of the
    sequence (``positions``; ``merge``: the log-sum-exp merge over the
    ranks that hold the others).  Where the heads are split, every query
    head attends (all-gathered over 'model') and this rank's are kept."""
    hl = q.shape[1]
    if sharded:
        q = all_gather(q, 1, tp.model)
    out = decode_attention(q, k.to(q.dtype), v.to(q.dtype), kv_len=kv_len,
                           positions=positions, merge=merge)
    if sharded:
        lo = tp.lo(hl, sharded)
        out = out[:, lo:lo + hl]
    return out


def attn_decode(p: Attention, cfg, x1, cache_kv, pos_scalar: int, tp=None):
    """Single-token decode.  x1: [b, 1, D]; cache_kv: (k, v) [b, KV, S, dh];
    pos_scalar: position of the new token.  Returns (y1, new_cache).  On a
    mesh the cache may hold one slice of the sequence, as its spec says
    (``tp.at``): the new position is written where this rank holds it and
    the partial softmaxes merge over the split (``decode_heads``)."""
    tp = tp or ONE
    sh = tp.sharded(p)
    b = x1.shape[0]
    dev = x1.device
    pos = torch.full((b, 1), pos_scalar, dtype=torch.int32, device=dev)
    q, k, v = _project_qkv(p, cfg, tp.enter(x1, sh), pos, tp, sh)
    lo = tp.lo(q.shape[1], sh)
    ck, cv = cache_kv
    idx, merge = tp.cache_positions("kv", 2, ck.shape[2], dev)
    hit = (idx == pos_scalar)[None, None, :, None]
    ck = torch.where(hit, k.to(ck.dtype), ck)
    cv = torch.where(hit, v.to(cv.dtype), cv)
    kv_len = torch.full((b,), pos_scalar + 1, dtype=torch.int32, device=dev)
    out = decode_heads(q, ck, cv, tp, sh, kv_len=kv_len,
                       positions=idx if merge else None, merge=merge)
    return tp.leave(_out_proj(p, _head_mask(cfg, out, lo)), sh), (ck, cv)


def init_kv_cache(cfg, batch: int, length: int, dtype, device) -> tuple:
    shape = (batch, cfg.padded_kv_heads, length, cfg.d_head)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
