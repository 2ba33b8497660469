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

from repro_torch.configs.base import ArchConfig, ShapeSpec
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


# ---------------------------------------------------------------------------
# input specs (the dry run's stand-ins: meta tensors, nothing allocated)
# ---------------------------------------------------------------------------
def _whisper_lens(cfg: ArchConfig, shape: ShapeSpec) -> tuple[int, int]:
    """Map the LM (seq_len, batch) cell onto enc/dec lengths: the encoder
    takes seq_len frames; the decoder is bounded by Whisper's 448-position
    window."""
    enc = shape.seq_len
    dec = min(cfg.max_target_len, max(8, shape.seq_len // 8))
    return enc, dec


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Meta tensors for every model input of this (arch, shape) cell, with
    the reference's keys, shapes and dtypes."""
    B, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if cfg.is_encdec:
        enc, dec = _whisper_lens(cfg, shape)
        if shape.kind == "train":
            return {"frames": sds((B, enc, cfg.d_model), f32),
                    "tokens": sds((B, dec), i32), "labels": sds((B, dec), i32)}
        if shape.kind == "prefill":
            return {"frames": sds((B, enc, cfg.d_model), f32), "tokens": sds((B, dec), i32)}
        return {"token": sds((B,), i32)}

    if cfg.frontend == "vision_stub":
        n_img = cfg.n_image_tokens
        s_txt = max(1, S - n_img)
        if shape.kind == "train":
            return {"tokens": sds((B, s_txt), i32),
                    "image_embeds": sds((B, n_img, cfg.d_model), f32),
                    "labels": sds((B, s_txt + n_img), i32)}
        if shape.kind == "prefill":
            return {"tokens": sds((B, s_txt), i32),
                    "image_embeds": sds((B, n_img, cfg.d_model), f32)}
        return {"token": sds((B,), i32)}

    if shape.kind == "train":
        return {"tokens": sds((B, S), i32), "labels": sds((B, S), i32)}
    if shape.kind == "prefill":
        return {"tokens": sds((B, S), i32)}
    return {"token": sds((B,), i32)}


def cache_length(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """The cell's ``init_cache`` length: the sequence's, or for an enc-dec
    config the encoder's."""
    return _whisper_lens(cfg, shape)[0] if cfg.is_encdec else shape.seq_len


def cache_specs(cfg: ArchConfig, shape: ShapeSpec):
    """The decode cache of this cell on the meta device."""
    return init_cache(cfg, shape.global_batch, cache_length(cfg, shape), device="meta")


def exact_param_count(cfg: ArchConfig) -> int:
    """Every parameter of the model, counted on the meta device."""
    return param_count(param_specs(cfg))
