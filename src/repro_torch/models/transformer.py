"""Decoder-LM assembly (port of ``repro/models/transformer.py``).

The reference scans ``n_periods`` stacked copies of the config's
``block_pattern``; eager PyTorch has no use for the scan, so the layers are
a ``ModuleList`` of ``n_layers`` blocks, layer ``l`` being period ``l`` of
the reference's stacked leaves (models/convert.py unstacks them).  This
slice ports the dense ``"attn"`` block (GQA attention + dense FFN), which
carries qwen2.5-3b; the other block kinds raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (MLP, Dense, Norm, _frozen,
                                       truncated_normal)

_NOT_PORTED = {
    "attn_moe": "the MoE FFN (ROADMAP Queue 1 item 12)",
    "mamba": "the Mamba SSM block (ROADMAP Queue 1 item 12)",
    "mamba_moe": "the Mamba SSM and MoE blocks (ROADMAP Queue 1 item 12)",
    "mlstm": "the xLSTM blocks (ROADMAP Queue 1 item 12)",
    "slstm": "the xLSTM blocks (ROADMAP Queue 1 item 12)",
}


def check_supported(cfg: ArchConfig) -> None:
    for kind in cfg.block_pattern:
        if kind != "attn":
            why = _NOT_PORTED.get(kind, f"block kind {kind!r}")
            raise NotImplementedError(f"{cfg.name}: {why} is not ported yet")


def _dtype(cfg: ArchConfig):
    return getattr(torch, cfg.param_dtype)


class AttnBlock(nn.Module):
    """Pre-norm residual block: x + attn(norm1(x)), then + ffn(norm2(x))."""

    def __init__(self, norm1: Norm, attn: attn_mod.Attention, norm2: Norm,
                 ffn: MLP | None):
        super().__init__()
        self.norm1, self.attn, self.norm2, self.ffn = norm1, attn, norm2, ffn

    @classmethod
    def init(cls, cfg, dtype, *, generator, device):
        norm = lambda: Norm.init(cfg.d_model, cfg.norm, cfg.norm_eps, dtype, device)
        attn = attn_mod.Attention.init(cfg, dtype, generator=generator, device=device)
        ffn = (MLP.init(cfg.d_model, cfg.d_ff, dtype, generator=generator,
                        device=device, gated=cfg.gated_mlp) if cfg.d_ff else None)
        return cls(norm(), attn, norm(), ffn)

    def forward(self, cfg, x, pos, attention=None):
        h = self.norm1(x)
        x = x + attn_mod.attn_apply(self.attn, cfg, h, pos=pos, attention=attention)
        return self._ffn(x)

    def decode(self, cfg, x1, cslice, pos_scalar):
        h = self.norm1(x1)
        y, kv = attn_mod.attn_decode(self.attn, cfg, h, cslice["kv"], pos_scalar)
        return self._ffn(x1 + y), {"kv": kv}

    def _ffn(self, x):
        if self.ffn is None:
            return x
        return x + self.ffn(self.norm2(x))


class LM(nn.Module):
    """Parameters of a decoder LM: embedding (also the head when tied),
    ``blocks`` (one per layer), final norm and the optional untied
    ``lm_head``.  (Learned positions belong to the enc-dec model alone.)"""

    def __init__(self, embed, final_norm: Norm, blocks, lm_head: Dense | None = None):
        super().__init__()
        self.embed = _frozen(embed)
        self.final_norm = final_norm
        self.blocks = nn.ModuleList(blocks)
        self.lm_head = lm_head

    def head(self, x):
        if self.lm_head is None:
            return x @ self.embed.T.to(x.dtype)
        return self.lm_head(x)


def init_lm(cfg: ArchConfig, generator: torch.Generator, device) -> LM:
    check_supported(cfg)
    dtype = _dtype(cfg)
    kw = dict(generator=generator, device=device)
    embed = truncated_normal((cfg.padded_vocab, cfg.d_model), 1.0, dtype, **kw)
    final_norm = Norm.init(cfg.d_model, cfg.norm, cfg.norm_eps, dtype, device)
    lm_head = (None if cfg.tie_embeddings
               else Dense.init(cfg.d_model, cfg.padded_vocab, dtype, **kw))
    blocks = [AttnBlock.init(cfg, dtype, **kw) for _ in range(cfg.n_layers)]
    return LM(embed, final_norm, blocks, lm_head)


def embed_inputs(params: LM, cfg: ArchConfig, batch: dict):
    """Token (+ vision-stub) embedding.  Returns (x [b, s, D], pos [b, s])."""
    dt = getattr(torch, cfg.compute_dtype)
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device).long()
    x = params.embed[tokens].to(dt)
    if cfg.frontend == "vision_stub":
        img = torch.as_tensor(batch["image_embeds"], device=x.device).to(dt)
        x = torch.cat([img, x], dim=1)
    b, s, _ = x.shape
    pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    return x, pos


def hidden_states(params: LM, cfg: ArchConfig, batch: dict, *, _attention=None):
    """Final pre-head hidden states [b, s, D] (the kNN-LM key tap)."""
    x, pos = embed_inputs(params, cfg, batch)
    for blk in params.blocks:
        x = blk(cfg, x, pos, _attention)
    return params.final_norm(x)


def lm_forward(params: LM, cfg: ArchConfig, batch: dict, *, _attention=None):
    """Full-sequence forward.  Returns (logits [b, s, V], aux dict).
    ``_attention`` (private) replaces the attention entry point, so a caller
    can run the plain version on the card and compare."""
    logits = params.head(hidden_states(params, cfg, batch, _attention=_attention))
    zero = torch.zeros((), device=logits.device)
    return logits, {"lb_loss": zero, "z_loss": zero, "drop_frac": zero}


def init_cache(cfg: ArchConfig, batch: int, length: int, dtype=None,
               device=None) -> list:
    """One ``{"kv": (k, v)}`` entry per layer, each [b, KV, length, dh]."""
    check_supported(cfg)
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    return [{"kv": attn_mod.init_kv_cache(cfg, batch, length, dtype, device)}
            for _ in range(cfg.n_layers)]


def lm_decode_step(params: LM, cfg: ArchConfig, token, cache, pos_scalar: int):
    """token: [b] int; pos_scalar: int.  Returns (logits [b, V], new cache)."""
    dt = getattr(torch, cfg.compute_dtype)
    token = torch.as_tensor(token, device=params.embed.device).long()
    x = params.embed[token][:, None, :].to(dt)
    new_cache = []
    for blk, cslice in zip(params.blocks, cache):
        x, nc = blk.decode(cfg, x, cslice, pos_scalar)
        new_cache.append(nc)
    logits = params.head(params.final_norm(x))
    return logits[:, 0], new_cache
