"""Decoder-LM assembly (port of ``repro/models/transformer.py``).

The reference scans ``n_periods`` stacked copies of the config's
``block_pattern``; eager PyTorch has no use for the scan, so the layers are
a ``ModuleList`` of ``n_layers`` blocks, layer ``p * len(pattern) + j``
being period ``p`` of the reference's ``blocks[j]`` leaves
(models/convert.py unstacks them).  Every function here takes the mesh
context ``tp`` (dist/tp.py; None on one device), so the sharded runtime
(dist/parallel.py) runs this code on its view of a rank's shards.  The block kinds are ``attn`` (GQA
attention + dense FFN), ``attn_moe`` (+ the MoE FFN), ``mamba``,
``mamba_moe`` and the xLSTM kinds ``mlstm`` and ``slstm``, which carry no
FFN (the reference returns after their mixer).
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.tp import ONE
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (MLP, Dense, Norm, _frozen, mlp_apply, norm,
                                       truncated_normal)

class _Recurrent(NamedTuple):
    """An xLSTM kind's mixer class and functions."""
    mixer: type
    apply: Callable
    decode: Callable
    init_cache: Callable


_XLSTM = {"mlstm": _Recurrent(xlstm_mod.MLSTM, xlstm_mod.mlstm_apply, xlstm_mod.mlstm_decode,
                              xlstm_mod.mlstm_init_cache),
          "slstm": _Recurrent(xlstm_mod.SLSTM, xlstm_mod.slstm_apply, xlstm_mod.slstm_decode,
                              xlstm_mod.slstm_init_cache)}


def _dtype(cfg: ArchConfig):
    return getattr(torch, cfg.param_dtype)


AUX_KEYS = ("lb_loss", "z_loss", "drop_frac")


def _span(name: str):
    """A ``block.<name>`` range for torch.profiler around a block's mixer or
    FFN, so a profile splits its device time by layer kind; a no-op while
    no profiler runs."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(f"block.{name}")
    return contextlib.nullcontext()


class Block(nn.Module):
    """Pre-norm residual block of one ``kind``: x + mixer(norm1(x)), then
    + ffn(norm2(x)).  The mixer is an ``Attention`` (``attn*`` kinds), a
    ``Mamba`` (``mamba*``), an ``MLSTM`` or an ``SLSTM``; the FFN a ``MoE``
    (``*_moe``), an ``MLP``, or none when ``d_ff`` is 0.  The xLSTM kinds
    have no ``norm2`` and no FFN (reference ``_block_apply``/``_block_decode``)."""

    def __init__(self, kind: str, norm1: Norm, mixer: nn.Module, norm2: Norm | None,
                 ffn: nn.Module | None):
        super().__init__()
        self.kind = kind
        self.norm1, self.mixer, self.norm2, self.ffn = norm1, mixer, norm2, ffn

    @classmethod
    def init(cls, kind, cfg, dtype, *, generator, device):
        kw = dict(generator=generator, device=device)
        norm = lambda: Norm.init(cfg.d_model, cfg.norm, cfg.norm_eps, dtype, device)
        if kind in _XLSTM:
            return cls(kind, norm(), _XLSTM[kind].mixer.init(cfg, dtype, **kw), None, None)
        if not kind.startswith(("attn", "mamba")):
            raise ValueError(kind)
        mixer = (attn_mod.Attention.init(cfg, dtype, **kw) if kind.startswith("attn")
                 else ssm_mod.Mamba.init(cfg, dtype, **kw))
        if kind.endswith("_moe"):
            ffn = moe_mod.MoE.init(cfg, dtype, **kw)
        else:
            ffn = (MLP.init(cfg.d_model, cfg.d_ff, dtype, gated=cfg.gated_mlp, **kw)
                   if cfg.d_ff else None)
        return cls(kind, norm(), mixer, norm(), ffn)


def block_apply(blk, cfg, x, pos, attention=None, routing=None, tp=None):
    """One block (a ``Block``, or dist/parallel.py's view of one with its
    mesh context ``tp``) on x in the residual stream's layout -> (x, aux
    dict or None)."""
    h = norm(blk.norm1, x, tp)
    if blk.kind in _XLSTM:
        with _span(blk.kind):
            return x + _XLSTM[blk.kind].apply(blk.mixer, cfg, h, tp=tp), None
    if blk.kind.startswith("attn"):
        with _span("attn"):
            x = x + attn_mod.attn_apply(blk.mixer, cfg, h, pos=pos, attention=attention, tp=tp)
    else:
        with _span("mamba"):
            x = x + ssm_mod.mamba_apply(blk.mixer, cfg, h, tp=tp)
    return _ffn(blk, cfg, x, None, routing, tp)


def block_decode(blk, cfg, x1, cslice, pos_scalar, routing=None, tp=None):
    """One block's cached decode of one position -> (x1, its new cache);
    on a mesh ``tp`` carries the layer's cache specs (``TP.at``)."""
    h = norm(blk.norm1, x1, tp)
    if blk.kind in _XLSTM:
        with _span(blk.kind):
            y, new_c = _XLSTM[blk.kind].decode(blk.mixer, cfg, h, cslice, tp=tp)
        return x1 + y, new_c
    if blk.kind.startswith("attn"):
        with _span("attn"):
            y, kv = attn_mod.attn_decode(blk.mixer, cfg, h, cslice["kv"], pos_scalar, tp)
        new_c = {"kv": kv}
    else:
        with _span("mamba"):
            y, new_c = ssm_mod.mamba_decode(blk.mixer, cfg, h, cslice, tp=tp)
    # dropless at decode: at worst every token routes to one expert
    x1, _ = _ffn(blk, cfg, x1 + y, x1.shape[0], routing, tp)
    return x1, new_c


def _ffn(blk, cfg, x, capacity, routing, tp):
    if blk.ffn is None:
        return x, None
    h = norm(blk.norm2, x, tp)
    if blk.kind.endswith("_moe"):
        with _span("moe"):
            y, aux = moe_mod.moe_block(blk.ffn, cfg, h, capacity, tp, _routing=routing)
        return x + y, aux
    with _span("mlp"):
        return x + mlp_apply(blk.ffn, h, tp), None


class LM(nn.Module):
    """Parameters of a decoder LM: embedding (also the head when tied),
    ``blocks`` (one per layer), final norm, the optional untied ``lm_head``
    and, when ``cfg.pos_embedding == "learned"``, ``pos_embed``
    [max_target_len, d_model]."""

    def __init__(self, embed, final_norm: Norm, blocks, lm_head: Dense | None = None,
                 pos_embed: torch.Tensor | None = None):
        super().__init__()
        self.embed = _frozen(embed)
        self.final_norm = final_norm
        self.blocks = nn.ModuleList(blocks)
        self.lm_head = lm_head
        self.pos_embed = None if pos_embed is None else _frozen(pos_embed)


def init_lm(cfg: ArchConfig, generator: torch.Generator, device) -> LM:
    dtype = _dtype(cfg)
    kw = dict(generator=generator, device=device)
    embed = truncated_normal((cfg.padded_vocab, cfg.d_model), 1.0, dtype, **kw)
    final_norm = Norm.init(cfg.d_model, cfg.norm, cfg.norm_eps, dtype, device)
    lm_head = (None if cfg.tie_embeddings
               else Dense.init(cfg.d_model, cfg.padded_vocab, dtype, **kw))
    pattern = cfg.block_pattern
    blocks = [Block.init(pattern[layer % len(pattern)], cfg, dtype, **kw)
              for layer in range(cfg.n_layers)]
    pos_embed = (truncated_normal((cfg.max_target_len, cfg.d_model), 0.02, dtype, **kw)
                 if cfg.pos_embedding == "learned" else None)
    return LM(embed, final_norm, blocks, lm_head, pos_embed)


def embed_inputs(params: LM, cfg: ArchConfig, batch: dict, tp=None):
    """Token (+ vision-stub) embedding, + learned positions where the
    config has them.  Returns (x [b, s, D], pos [b, s]); on a mesh x is in
    the residual stream's layout (this rank's slice of the sequence under
    sequence parallelism, the image positions included) and pos covers
    the whole sequence."""
    tp = tp or ONE
    dt = getattr(torch, cfg.compute_dtype)
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device).long()
    img = None
    if cfg.frontend == "vision_stub":
        img = torch.as_tensor(batch["image_embeds"], device=params.embed.device)
    x = tp.embed(params, tokens, dt, img)
    b, s = tokens.shape[0], tokens.shape[1] + (0 if img is None else img.shape[1])
    pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    if cfg.pos_embedding == "learned":
        x = x + tp.seq_slice(tp.rep(params.pos_embed, False)[:s], 0).to(dt)
    return x, pos


def run_periods(cfg: ArchConfig, x, block_fn, remat: bool = False):
    """x through every layer, period by period of ``cfg.block_pattern``:
    ``block_fn(layer, x) -> (x, aux or None)``.  -> (x, aux sums [3] over
    the MoE layers, in ``AUX_KEYS`` order): each period's aux summed apart
    and the periods' sums added at the end (the reference's scan); with
    ``remat`` while autograd records, each period is one activation
    checkpoint, recomputed in the backward (the reference's
    ``jax.checkpoint(period_fn)``).  The one-device trunk and the sharded
    one (dist/parallel.py) both run their layers here."""
    n = len(cfg.block_pattern)

    def period(x, p):
        sums = torch.zeros((3,), dtype=torch.float32, device=x.device)
        for layer in range(p * n, (p + 1) * n):
            x, aux = block_fn(layer, x)
            if aux is not None:
                sums = sums + torch.stack([aux[k] for k in AUX_KEYS])
        return x, sums

    per_period = []
    for p in range(cfg.n_periods):
        if remat and torch.is_grad_enabled():
            x, sums = checkpoint(period, x, p, use_reentrant=False)
        else:
            x, sums = period(x, p)
        per_period.append(sums)
    return x, torch.stack(per_period).sum(0)


def aux_means(cfg: ArchConfig, sums) -> dict:
    """``run_periods``' aux sums as the forward's aux dict: divided by
    ``max(1, n_moe * n_periods)`` (zeros without MoE layers)."""
    n_moe = sum(1 for k in cfg.block_pattern if k.endswith("_moe"))
    return dict(zip(AUX_KEYS, (sums / max(1, n_moe * cfg.n_periods)).unbind()))


def _trunk(params: LM, cfg: ArchConfig, batch: dict, attention, routing,
           remat: bool = False, tp=None):
    """-> (final-normed hidden states [b, s, D], aux sums [3] over the MoE
    layers, in ``AUX_KEYS`` order), the layers run by ``run_periods``."""
    x, pos = embed_inputs(params, cfg, batch, tp)
    x, sums = run_periods(cfg, x, lambda layer, x: block_apply(
        params.blocks[layer], cfg, x, pos, attention, routing, tp), remat)
    return norm(params.final_norm, x, tp), sums


def hidden_states(params: LM, cfg: ArchConfig, batch: dict, *, _attention=None):
    """Final pre-head hidden states [b, s, D] (the kNN-LM key tap)."""
    return _trunk(params, cfg, batch, _attention, None)[0]


def lm_forward(params: LM, cfg: ArchConfig, batch: dict, *, remat: bool = False,
               _attention=None, _routing=None, tp=None):
    """Full-sequence forward.  Returns (logits [b, s, V], aux dict): the
    MoE layers' aux summed and divided by ``max(1, n_moe * n_periods)``
    (zeros without MoE layers).  ``remat`` checkpoints each period
    (``_trunk``).  ``_attention`` (private) replaces the attention entry
    point, so a caller can run the plain version on the card and compare;
    ``_routing`` (private) collects each MoE layer's routing
    (models/moe.py), once more for each period that remat recomputes.  On
    a mesh (``tp``; dist/parallel.py's view of this rank's shards as
    ``params``) the logits are this rank's vocab slice."""
    tp = tp or ONE
    x, sums = _trunk(params, cfg, batch, _attention, _routing, remat, tp)
    return tp.head(params, x), aux_means(cfg, sums)


def init_cache(cfg: ArchConfig, batch: int, length: int, dtype=None,
               device=None) -> list:
    """One entry per layer: ``{"kv": (k, v)}`` [b, KV, length, dh] for an
    attention layer, ``{"conv", "h"}`` for a Mamba layer, ``{"conv", "C",
    "n", "m"}`` for an mLSTM layer and ``{"c", "n", "h", "m"}`` for an sLSTM
    layer (the recurrent kinds' caches do not grow with ``length``)."""
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    pattern = cfg.block_pattern

    def one(kind):
        if kind.startswith("attn"):
            return {"kv": attn_mod.init_kv_cache(cfg, batch, length, dtype, device)}
        if kind in _XLSTM:
            return _XLSTM[kind].init_cache(cfg, batch, dtype, device)
        return ssm_mod.mamba_init_cache(cfg, batch, dtype, device)

    return [one(pattern[layer % len(pattern)]) for layer in range(cfg.n_layers)]


def lm_decode_step(params: LM, cfg: ArchConfig, token, cache, pos_scalar: int, *,
                   _routing=None, tp=None):
    """token: [b] int; pos_scalar: int.  Returns (logits [b, V], new
    cache); on a mesh (``tp``, whose ``cache_spec`` is the cache's specs
    by layer) the logits are this rank's vocab slice."""
    tp = tp or ONE
    dt = getattr(torch, cfg.compute_dtype)
    token = torch.as_tensor(token, device=params.embed.device).long()
    x = tp.embed(params, token[:, None], dt)
    if cfg.pos_embedding == "learned":
        x = x + params.pos_embed[pos_scalar][None, None].to(dt)
    specs = tp.cache_spec
    new_cache = []
    for layer, cslice in enumerate(cache):
        x, nc = block_decode(params.blocks[layer], cfg, x, cslice, pos_scalar, _routing,
                             tp.at(specs[layer]) if specs is not None else tp)
        new_cache.append(nc)
    logits = tp.head(params, norm(params.final_norm, x, tp))
    return logits[:, 0], new_cache
