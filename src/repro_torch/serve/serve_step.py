"""Serving steps: prefill and cached greedy decode on one device (port of
the single-device functions of ``repro/serve/serve_step.py``).

The reference's builders also return GSPMD shardings for its mesh; the
port runs on one card, so each builder returns the step function alone.
The kNN-LM mixing hooks in through serve/knnlm.py.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M


def make_decode_step(cfg: ArchConfig):
    """decode_fn(params, token, cache, pos) -> (next_token, logits, cache),
    the next token greedy (argmax)."""

    def decode_fn(params, token, cache, pos):
        logits, cache = M.decode_step(params, cfg, token, cache, pos)
        return logits.argmax(-1).to(torch.int32), logits, cache

    return decode_fn


def make_prefill_step(cfg: ArchConfig, *, _attention=None):
    """prefill_fn(params, batch) -> logits [b, s, V]: the full-sequence
    forward (the flash kernel on the card).  ``_attention`` (private)
    replaces the attention entry point, for comparisons on the card."""

    def prefill_fn(params, batch):
        logits, _ = M.forward(params, cfg, batch, _attention=_attention)
        return logits

    return prefill_fn
