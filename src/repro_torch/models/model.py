"""Unified model API: init / forward / decode (port of
``repro/models/model.py``), dispatching on ``cfg.is_encdec`` as the
reference does: decoder LMs (every block family) through
``models/transformer.py``, the encoder-decoder (whisper) through
``models/encdec.py``.  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.smtree import resolve_device
from repro_torch.models import encdec, transformer


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None):
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    drawn on the device itself: a ``transformer.LM`` or an
    ``encdec.EncDec``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.is_encdec:
        return encdec.init_encdec(cfg, gen, dev)
    return transformer.init_lm(cfg, gen, dev)


def forward(params, cfg: ArchConfig, batch: dict, *, _attention=None, _routing=None):
    """Full-sequence forward -> (logits, aux).  An enc-dec batch is
    ``{"frames", "tokens"}``."""
    if cfg.is_encdec:
        return encdec.encdec_forward(params, cfg, batch, _attention=_attention)
    return transformer.lm_forward(params, cfg, batch, _attention=_attention,
                                  _routing=_routing)


def init_cache(cfg: ArchConfig, batch: int, length: int, dtype=None, *,
               device=None):
    """The decode cache; for an enc-dec config ``length`` is the encoder's
    (the cross K/V's) length, as in the reference."""
    dev = resolve_device(device)
    if cfg.is_encdec:
        return encdec.encdec_init_cache(cfg, batch, length, dtype, device=dev)
    return transformer.init_cache(cfg, batch, length, dtype, device=dev)


def decode_step(params, cfg: ArchConfig, token, cache, pos_scalar: int, *,
                _routing=None):
    """One-token decode with cache -> (logits [b, V], new cache)."""
    if cfg.is_encdec:
        return encdec.encdec_decode_step(params, cfg, token, cache, int(pos_scalar))
    return transformer.lm_decode_step(params, cfg, token, cache, int(pos_scalar),
                                      _routing=_routing)


def param_count(params) -> int:
    return sum(p.numel() for p in params.parameters())
