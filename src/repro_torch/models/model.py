"""Unified model API: init / forward / decode (port of
``repro/models/model.py``), dispatching on ``cfg.is_encdec`` as the
reference does: decoder LMs (every block family) through
``models/transformer.py``, the encoder-decoder (whisper) through
``models/encdec.py``.  Entry points run on the card unless the caller
passes ``device="cpu"``.  Parameters are made frozen (serving runs no
backward); ``trainable`` turns them on for training.
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


def param_specs(cfg: ArchConfig):
    """The model with every parameter on the meta device: its names,
    shapes and dtypes, nothing allocated (the reference's ``param_specs``)."""
    gen, meta = torch.Generator(), torch.device("meta")
    if cfg.is_encdec:
        return encdec.init_encdec(cfg, gen, meta)
    return transformer.init_lm(cfg, gen, meta)


def trainable(params):
    """Every parameter of an ``LM`` or ``EncDec`` set to require grad (in
    place); returns ``params``."""
    for p in params.parameters():
        p.requires_grad_(True)
    return params


def forward(params, cfg: ArchConfig, batch: dict, *, remat: bool = False,
            _attention=None, _routing=None):
    """Full-sequence forward -> (logits, aux).  An enc-dec batch is
    ``{"frames", "tokens"}``.  ``remat`` checkpoints activations by period
    of the block pattern (the enc-dec: by decoder block) while autograd
    records, as the reference's ``jax.checkpoint`` does."""
    if cfg.is_encdec:
        return encdec.encdec_forward(params, cfg, batch, remat=remat,
                                     _attention=_attention)
    return transformer.lm_forward(params, cfg, batch, remat=remat,
                                  _attention=_attention, _routing=_routing)


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


def loss_fn(logits, labels, mask):
    """Mean next-token cross-entropy (labels already shifted), in float32.
    The gold logit is picked by comparing an iota with the labels and a
    masked sum, as in the reference, not by a gather, so the backward is
    elementwise rather than a scatter."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    labels = torch.as_tensor(labels, device=lf.device)
    mask = torch.as_tensor(mask, device=lf.device)
    hit = torch.arange(lf.shape[-1], device=lf.device) == labels[..., None].long()
    gold = torch.where(hit, lf, 0.0).sum(-1)
    nll = (lse - gold) * mask
    return nll.sum() / mask.sum().clamp_min(1)


def param_count(params) -> int:
    return sum(p.numel() for p in params.parameters())
