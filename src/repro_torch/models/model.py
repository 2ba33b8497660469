"""Unified model API: init / forward / decode (port of
``repro/models/model.py``).

Entry points run on the card unless the caller passes ``device="cpu"``.
Encoder-decoder configs (whisper) and the block families other than the
dense ``"attn"`` block raise ``NotImplementedError`` (ROADMAP Queue 1
item 12).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.smtree import resolve_device
from repro_torch.models import transformer

_ENCDEC = "encoder-decoder models (ROADMAP Queue 1 item 12) are not ported yet"


def _check(cfg: ArchConfig) -> None:
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: {_ENCDEC}")


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None) -> transformer.LM:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    drawn on the device itself."""
    _check(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return transformer.init_lm(cfg, gen, dev)


def forward(params, cfg: ArchConfig, batch: dict, *, _attention=None):
    """Full-sequence forward -> (logits, aux)."""
    _check(cfg)
    return transformer.lm_forward(params, cfg, batch, _attention=_attention)


def init_cache(cfg: ArchConfig, batch: int, length: int, dtype=None, *,
               device=None):
    _check(cfg)
    return transformer.init_cache(cfg, batch, length, dtype,
                                  device=resolve_device(device))


def decode_step(params, cfg: ArchConfig, token, cache, pos_scalar: int):
    """One-token decode with cache -> (logits [b, V], new cache)."""
    _check(cfg)
    return transformer.lm_decode_step(params, cfg, token, cache, int(pos_scalar))


def param_count(params) -> int:
    return sum(p.numel() for p in params.parameters())
