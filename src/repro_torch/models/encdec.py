"""Whisper-style encoder-decoder (the audio family).  Port of
``repro/models/encdec.py``.

The conv frontend is a stub: the caller supplies the frame embeddings
[b, s_enc, D] that the two conv layers would emit.  Encoder: bidirectional
self-attention over the frames, sinusoidal positions.  Decoder: causal
self-attention, cross-attention onto the encoder's memory, learned
positions ``dec_pos`` bounded at ``max_target_len``; the head is tied
(logits = x @ embed.T).  As in the reference, the projections take no
bias, no rotary embedding and no head mask (``_proj_qkv``).  All three
attentions of the forward go through ``kernels.ops.attention``: the flash
kernel on CUDA tensors.  The cached decode attends with
``decode_attention``: the self-attention cache is written at ``pos`` by
mask and read up to ``pos + 1``, the cross K/V (filled once by
``encdec_prefill_cache``) in full.  Every function that attends takes the
private ``_attention`` hook of ``attention.attn_apply``, so the card can
run the plain version and compare.  Under torch.profiler the blocks open
``block.enc_attn`` (the encoder's), ``block.attn``, ``block.xattn`` and
``block.mlp`` ranges, as ``transformer.Block`` does.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.attention_plain import decode_attention
from repro_torch.models.attention import Attention
from repro_torch.models.layers import (MLP, Norm, _frozen, sinusoidal_positions,
                                       truncated_normal)
from repro_torch.models.transformer import _span


class EncDecBlock(nn.Module):
    """An encoder block (``xattn`` None: norm1, self-attention, norm2, FFN)
    or a decoder block (+ ``normx`` and the cross-attention ``xattn``)."""

    def __init__(self, norm1: Norm, attn: Attention, norm2: Norm, ffn: MLP,
                 normx: Norm | None = None, xattn: Attention | None = None):
        super().__init__()
        self.norm1, self.attn, self.norm2, self.ffn = norm1, attn, norm2, ffn
        self.normx, self.xattn = normx, xattn

    @classmethod
    def init(cls, cfg, dtype, *, generator, device, decoder: bool):
        kw = dict(generator=generator, device=device)
        norm = lambda: Norm.init(cfg.d_model, cfg.norm, cfg.norm_eps, dtype, device)
        attn = lambda: Attention.init(cfg, dtype, **kw)
        blk = cls(norm(), attn(), norm(),
                  MLP.init(cfg.d_model, cfg.d_ff, dtype, gated=cfg.gated_mlp, **kw))
        if decoder:
            blk.normx, blk.xattn = norm(), attn()
        return blk


class EncDec(nn.Module):
    """``embed`` [V, D] (also the head), ``dec_pos`` [max_target_len, D],
    ``enc_blocks`` and ``dec_blocks`` (one per layer), ``enc_norm`` and
    ``final_norm``."""

    def __init__(self, embed, dec_pos, enc_blocks, dec_blocks, enc_norm: Norm,
                 final_norm: Norm):
        super().__init__()
        self.embed, self.dec_pos = _frozen(embed), _frozen(dec_pos)
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.enc_norm, self.final_norm = enc_norm, final_norm

    def head(self, x):
        return x @ self.embed.T.to(x.dtype)


def init_encdec(cfg: ArchConfig, generator: torch.Generator, device) -> EncDec:
    dtype = getattr(torch, cfg.param_dtype)
    kw = dict(generator=generator, device=device)
    norm = lambda: Norm.init(cfg.d_model, cfg.norm, cfg.norm_eps, dtype, device)
    block = lambda decoder: EncDecBlock.init(cfg, dtype, decoder=decoder, **kw)
    return EncDec(truncated_normal((cfg.padded_vocab, cfg.d_model), 1.0, dtype, **kw),
                  truncated_normal((cfg.max_target_len, cfg.d_model), 0.02, dtype, **kw),
                  [block(False) for _ in range(cfg.encoder_layers)],
                  [block(True) for _ in range(cfg.n_layers)], norm(), norm())


def _heads(x, w):
    """x: [b, s, D]; w: [D, H, dh] -> [b, H, s, dh]."""
    return torch.einsum("bsd,dhe->bhse", x, w.to(x.dtype))


def _out(p: Attention, o):
    return torch.einsum("bhse,hed->bsd", o, p.wo.to(o.dtype))


def _attend(p: Attention, x_q, x_kv, causal: bool, attention):
    q, k, v = _heads(x_q, p.wq), _heads(x_kv, p.wk), _heads(x_kv, p.wv)
    return _out(p, (attention or ops.attention)(q, k, v, causal=causal))


def encode(params: EncDec, cfg: ArchConfig, frames, *, _attention=None):
    """frames: [b, s_enc, D] stub embeddings -> the encoder's memory."""
    dt = getattr(torch, cfg.compute_dtype)
    x = torch.as_tensor(frames, device=params.embed.device).to(dt)
    _, s, D = x.shape
    x = x + torch.from_numpy(sinusoidal_positions(s, D)).to(x.device, dt)
    for blk in params.enc_blocks:
        h = blk.norm1(x)
        with _span("enc_attn"):
            x = x + _attend(blk.attn, h, h, False, _attention)
        with _span("mlp"):
            x = x + blk.ffn(blk.norm2(x))
    return params.enc_norm(x)


def encdec_forward(params: EncDec, cfg: ArchConfig, batch: dict, *, _attention=None):
    """batch: {frames [b, s_enc, D], tokens [b, s_dec]} -> (logits [b, s_dec,
    V], aux: zeros, the LM's keys)."""
    mem = encode(params, cfg, batch["frames"], _attention=_attention)
    tok = torch.as_tensor(batch["tokens"], device=mem.device).long()
    s = tok.shape[1]
    x = params.embed[tok].to(mem.dtype) + params.dec_pos[:s].to(mem.dtype)
    for blk in params.dec_blocks:
        h = blk.norm1(x)
        with _span("attn"):
            x = x + _attend(blk.attn, h, h, True, _attention)
        with _span("xattn"):
            x = x + _attend(blk.xattn, blk.normx(x), mem, False, _attention)
        with _span("mlp"):
            x = x + blk.ffn(blk.norm2(x))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return params.head(params.final_norm(x)), {k: zero for k in
                                                ("lb_loss", "z_loss", "drop_frac")}


# ---- cached decode ----------------------------------------------------------
def encdec_init_cache(cfg: ArchConfig, batch: int, enc_len: int, dtype=None,
                      device=None) -> dict:
    """The self-attention cache (bounded by ``max_target_len``) and the
    cross-attention K/V over ``enc_len`` frames, zero until
    ``encdec_prefill_cache`` fills them; each [n_layers, b, KV, S, dh]."""
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    L, KV, dh = cfg.n_layers, cfg.padded_kv_heads, cfg.d_head
    z = lambda S: torch.zeros((L, batch, KV, S, dh), dtype=dtype, device=device)
    S = cfg.max_target_len
    return {"self_k": z(S), "self_v": z(S), "cross_k": z(enc_len), "cross_v": z(enc_len)}


def encdec_prefill_cache(params: EncDec, cfg: ArchConfig, frames, cache: dict, *,
                         _attention=None) -> dict:
    """Run the encoder and fill the cross-attention K/V of every layer."""
    mem = encode(params, cfg, frames, _attention=_attention)
    ks = torch.stack([_heads(mem, blk.xattn.wk) for blk in params.dec_blocks])
    vs = torch.stack([_heads(mem, blk.xattn.wv) for blk in params.dec_blocks])
    return dict(cache, cross_k=ks.to(cache["cross_k"].dtype),
                cross_v=vs.to(cache["cross_v"].dtype))


def encdec_decode_step(params: EncDec, cfg: ArchConfig, token, cache: dict,
                       pos_scalar: int):
    """token: [b] int; pos_scalar: int -> (logits [b, V], new cache)."""
    dt = getattr(torch, cfg.compute_dtype)
    token = torch.as_tensor(token, device=params.embed.device).long()
    b = token.shape[0]
    x = params.embed[token][:, None, :].to(dt) + params.dec_pos[pos_scalar][None, None].to(dt)
    S = cache["self_k"].shape[3]
    hit = (torch.arange(S, device=x.device) == pos_scalar)[None, None, :, None]
    kv_len = torch.full((b,), pos_scalar + 1, dtype=torch.int32, device=x.device)
    sks, svs = [], []
    for i, blk in enumerate(params.dec_blocks):
        h = blk.norm1(x)
        q, k1, v1 = _heads(h, blk.attn.wq), _heads(h, blk.attn.wk), _heads(h, blk.attn.wv)
        sk = torch.where(hit, k1.to(cache["self_k"].dtype), cache["self_k"][i])
        sv = torch.where(hit, v1.to(cache["self_v"].dtype), cache["self_v"][i])
        sks.append(sk), svs.append(sv)
        with _span("attn"):
            x = x + _out(blk.attn, decode_attention(q, sk.to(q.dtype), sv.to(q.dtype),
                                                    kv_len=kv_len))
        with _span("xattn"):
            qx = _heads(blk.normx(x), blk.xattn.wq)
            ck, cv = cache["cross_k"][i], cache["cross_v"][i]
            x = x + _out(blk.xattn, decode_attention(qx, ck.to(qx.dtype), cv.to(qx.dtype)))
        with _span("mlp"):
            x = x + blk.ffn(blk.norm2(x))
    logits = params.head(params.final_norm(x))
    return logits[:, 0], dict(cache, self_k=torch.stack(sks), self_v=torch.stack(svs))
