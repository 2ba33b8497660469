"""Carry a JAX parameter tree into the port's modules.

``params_from_jax`` takes the tree of ``repro.models.model.init_params`` as
numpy arrays (``jax.tree.map(np.asarray, params)``: this module imports no
JAX) and unstacks the ``[n_periods, ...]`` block leaves of the reference's
layer scan into one port block per layer, so both packages run the same
weights.  Like every entry point of the port, it puts the weights on the
card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.smtree import resolve_device
from repro_torch.models import transformer
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Dense, Norm


def params_from_jax(params_np: dict, cfg: ArchConfig, *,
                    device=None) -> transformer.LM:
    transformer.check_supported(cfg)
    device = resolve_device(device)
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are not "
                                  "ported yet (ROADMAP Queue 1 item 12)")
    t = lambda a: torch.from_numpy(np.array(a, copy=True)).to(device)
    norm = lambda p: Norm(cfg.norm, cfg.norm_eps, t(p["scale"]),
                          t(p["bias"]) if "bias" in p else None)
    dense = lambda p: Dense(t(p["w"]), t(p["b"]) if "b" in p else None)

    stacked = params_np["blocks"][0]          # pattern ("attn",): one leaf set
    blocks = []
    for layer in range(cfg.n_layers):
        leaf = lambda a: a[layer]
        a = {k: leaf(v) for k, v in stacked["attn"].items()}
        attn = Attention(t(a["wq"]), t(a["wk"]), t(a["wv"]), t(a["wo"]),
                         *(t(a[n]) for n in ("bq", "bk", "bv") if n in a))
        ffn = None
        if "ffn" in stacked:
            f = {k: {n: leaf(x) for n, x in v.items()}
                 for k, v in stacked["ffn"].items()}
            ffn = MLP(dense(f["wi"]), dense(f["wo"]),
                      dense(f["wg"]) if "wg" in f else None)
        n1 = {k: leaf(v) for k, v in stacked["norm1"].items()}
        n2 = {k: leaf(v) for k, v in stacked["norm2"].items()}
        blocks.append(transformer.AttnBlock(norm(n1), attn, norm(n2), ffn))
    return transformer.LM(
        t(params_np["embed"]), norm(params_np["final_norm"]), blocks,
        dense(params_np["lm_head"]) if "lm_head" in params_np else None)
