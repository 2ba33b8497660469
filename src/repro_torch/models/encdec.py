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

Every function takes the mesh context ``tp`` (dist/tp.py; None on one
device): on a {data, model} mesh the three attentions shard by query
head as the decoder LM's does (where the model axis does not divide the
heads the table replicates ``wq`` and every rank runs the attention
whole), the MLPs by hidden dim, the tied head and the embedding by vocab
row; ``dec_pos`` is replicated, and the decode caches hold the slice of
their sequences that ``cache_pspecs`` gives a rank.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.tp import ONE
from repro_torch.kernels import ops
from repro_torch.models.attention import Attention, _repeat_kv, decode_heads
from repro_torch.models.layers import (MLP, Norm, _frozen, mlp_apply, norm,
                                       sinusoidal_positions, truncated_normal)
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


def _local_kv(k, v, lo: int, hl: int, H: int):
    """The K/V heads [b, KV, s, dh] that query heads [lo, lo + hl) of H read
    (GQA): all of them when the query heads are all here, the groups' heads
    where whole groups are here, else one repeated head per query head."""
    if hl == H:
        return k, v
    g = H // k.shape[1]
    if lo % g == 0 and hl % g == 0:
        return k[:, lo // g:(lo + hl) // g], v[:, lo // g:(lo + hl) // g]
    k, v = _repeat_kv(k, g), _repeat_kv(v, g)
    return k[:, lo:lo + hl], v[:, lo:lo + hl]


def _attend(p: Attention, x_q, x_kv, causal: bool, attention, tp=None):
    """Attention of x_q onto x_kv (the same tensor for self-attention).  On
    a mesh (``tp``) by query head as ``attention.attn_apply``: this rank's
    heads of ``wq``/``wo``, ``wk``/``wv`` whole, the row-parallel output
    leaving through ``tp.leave``; where the table replicates ``wq`` (the
    model axis does not divide the heads) every rank runs it whole."""
    tp = tp or ONE
    sh = tp.sharded(p)
    xq = tp.enter(x_q, sh)
    xkv = xq if x_kv is x_q else tp.enter(x_kv, sh)
    q = _heads(xq, p.wq)
    k, v = _heads(xkv, tp.rep(p.wk, sh)), _heads(xkv, tp.rep(p.wv, sh))
    hl = q.shape[1]
    k, v = _local_kv(k, v, tp.lo(hl, sh), hl, hl * tp.r.tp if sh else hl)
    return tp.leave(_out(p, (attention or ops.attention)(q, k, v, causal=causal)), sh)


def encode(params: EncDec, cfg: ArchConfig, frames, *, _attention=None, tp=None):
    """frames: [b, s_enc, D] stub embeddings -> the encoder's memory."""
    dt = getattr(torch, cfg.compute_dtype)
    x = torch.as_tensor(frames, device=params.embed.device).to(dt)
    _, s, D = x.shape
    x = x + torch.from_numpy(sinusoidal_positions(s, D)).to(x.device, dt)
    for blk in params.enc_blocks:
        h = norm(blk.norm1, x, tp)
        with _span("enc_attn"):
            x = x + _attend(blk.attn, h, h, False, _attention, tp)
        with _span("mlp"):
            x = x + mlp_apply(blk.ffn, norm(blk.norm2, x, tp), tp)
    return norm(params.enc_norm, x, tp)


def encdec_forward(params: EncDec, cfg: ArchConfig, batch: dict, *, remat: bool = False,
                   _attention=None, tp=None):
    """batch: {frames [b, s_enc, D], tokens [b, s_dec]} -> (logits [b, s_dec,
    V], aux: zeros, the LM's keys).  With ``remat`` while autograd records,
    each decoder block is one activation checkpoint (the encoder is not
    checkpointed), as in the reference.  On a mesh (``tp``;
    dist/parallel.py's view of this rank's shards as ``params``) the
    logits are this rank's vocab slice."""
    tp = tp or ONE
    mem = encode(params, cfg, batch["frames"], _attention=_attention, tp=tp)
    tok = torch.as_tensor(batch["tokens"], device=mem.device).long()
    s = tok.shape[1]
    x = tp.embed(params, tok, mem.dtype) + params.dec_pos[:s].to(mem.dtype)

    def block(x, i):
        # the block's weights are read inside the checkpoint, so a mesh
        # rank gathers its FSDP shards again in the recompute
        blk = params.dec_blocks[i]
        h = norm(blk.norm1, x, tp)
        with _span("attn"):
            x = x + _attend(blk.attn, h, h, True, _attention, tp)
        with _span("xattn"):
            x = x + _attend(blk.xattn, norm(blk.normx, x, tp), mem, False, _attention, tp)
        with _span("mlp"):
            return x + mlp_apply(blk.ffn, norm(blk.norm2, x, tp), tp)

    for i in range(len(params.dec_blocks)):
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, x, i, use_reentrant=False)
        else:
            x = block(x, i)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return tp.head(params, norm(params.final_norm, x, tp)), {
        k: zero for k in ("lb_loss", "z_loss", "drop_frac")}


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
                         _attention=None, tp=None) -> dict:
    """Run the encoder and fill the cross-attention K/V of every layer (on
    a mesh, this rank's slice of the frames where the cache's spec splits
    them)."""
    tp = tp or ONE
    mem = encode(params, cfg, frames, _attention=_attention, tp=tp)
    ks = torch.stack([_heads(mem, blk.xattn.wk) for blk in params.dec_blocks])
    vs = torch.stack([_heads(mem, blk.xattn.wv) for blk in params.dec_blocks])
    S = cache["cross_k"].shape[3]
    if S != ks.shape[3]:
        lo = tp.cache_offset("cross_k", 3, S)
        ks, vs = ks[:, :, :, lo:lo + S], vs[:, :, :, lo:lo + S]
    return dict(cache, cross_k=ks.to(cache["cross_k"].dtype),
                cross_v=vs.to(cache["cross_v"].dtype))


def encdec_decode_step(params: EncDec, cfg: ArchConfig, token, cache: dict,
                       pos_scalar: int, tp=None):
    """token: [b] int; pos_scalar: int -> (logits [b, V], new cache).  On a
    mesh (``tp``, whose ``cache_spec`` is the cache's specs) the self and
    cross K/V may hold one slice of their sequences: the new position is
    written where this rank holds it, every query head attends over the
    slice and the partial softmaxes merge over the split
    (``attention.decode_heads``); the logits are this rank's vocab slice."""
    tp = tp or ONE
    dt = getattr(torch, cfg.compute_dtype)
    token = torch.as_tensor(token, device=params.embed.device).long()
    b = token.shape[0]
    x = tp.embed(params, token[:, None], dt) + params.dec_pos[pos_scalar][None, None].to(dt)
    S = cache["self_k"].shape[3]
    idx, merge = tp.cache_positions("self_k", 3, S, x.device)
    _, xmerge = tp.cache_positions("cross_k", 3, cache["cross_k"].shape[3], x.device)
    hit = (idx == pos_scalar)[None, None, :, None]
    kv_len = torch.full((b,), pos_scalar + 1, dtype=torch.int32, device=x.device)
    sks, svs = [], []
    for i in range(len(params.dec_blocks)):
        blk = params.dec_blocks[i]
        sh, shx = tp.sharded(blk.attn), tp.sharded(blk.xattn)
        h = norm(blk.norm1, x, tp)
        q, k1, v1 = _heads(h, blk.attn.wq), _heads(h, blk.attn.wk), _heads(h, blk.attn.wv)
        sk = torch.where(hit, k1.to(cache["self_k"].dtype), cache["self_k"][i])
        sv = torch.where(hit, v1.to(cache["self_v"].dtype), cache["self_v"][i])
        sks.append(sk), svs.append(sv)
        with _span("attn"):
            o = decode_heads(q, sk, sv, tp, sh, kv_len=kv_len,
                             positions=idx if merge else None, merge=merge)
            x = x + tp.leave(_out(blk.attn, o), sh)
        with _span("xattn"):
            qx = _heads(norm(blk.normx, x, tp), blk.xattn.wq)
            o = decode_heads(qx, cache["cross_k"][i], cache["cross_v"][i], tp, shx, merge=xmerge)
            x = x + tp.leave(_out(blk.xattn, o), shx)
        with _span("mlp"):
            x = x + mlp_apply(blk.ffn, norm(blk.norm2, x, tp), tp)
    logits = tp.head(params, norm(params.final_norm, x, tp))
    return logits[:, 0], dict(cache, self_k=torch.stack(sks), self_v=torch.stack(svs))
