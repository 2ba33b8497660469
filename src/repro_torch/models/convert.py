"""Carry a JAX parameter tree into the port's modules.

``params_from_jax`` takes the tree of ``repro.models.model.init_params`` as
numpy arrays (``jax.tree.map(np.asarray, params)``: this module imports no
JAX) and unstacks the ``[n_periods, ...]`` block leaves of the reference's
layer scan into one port block per layer: layer ``p * len(pattern) + j``
is ``blocks[j]`` at index ``p`` (reference ``transformer.py:68-74``).
bfloat16 leaves (``ml_dtypes``, known here by the dtype's name) are read
through their 16-bit patterns, as ``dist/checkpoint.py`` reads them.  Like
every entry point of the port, it puts the weights on the card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.smtree import resolve_device
from repro_torch.models import transformer
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Dense, Norm
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import Mamba


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(params_np: dict, cfg: ArchConfig, *,
                    device=None) -> transformer.LM:
    transformer.check_supported(cfg)
    device = resolve_device(device)
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are not "
                                  "ported yet (ROADMAP Queue 1 item 12.4)")
    t = lambda a: _tensor(a, device)
    norm = lambda p: Norm(cfg.norm, cfg.norm_eps, t(p["scale"]),
                          t(p["bias"]) if "bias" in p else None)
    dense = lambda p: Dense(t(p["w"]), t(p["b"]) if "b" in p else None)
    mlp = lambda f: MLP(dense(f["wi"]), dense(f["wo"]), dense(f["wg"]) if "wg" in f else None)

    def at(tree, p):
        """The leaves of period ``p`` of a stacked subtree."""
        return {k: at(v, p) if isinstance(v, dict) else v[p] for k, v in tree.items()}

    pattern = cfg.block_pattern
    blocks = []
    for layer in range(cfg.n_layers):
        kind = pattern[layer % len(pattern)]
        leaves = at(params_np["blocks"][layer % len(pattern)], layer // len(pattern))
        if kind.startswith("attn"):
            a = leaves["attn"]
            mixer = Attention(t(a["wq"]), t(a["wk"]), t(a["wv"]), t(a["wo"]),
                              *(t(a[n]) for n in ("bq", "bk", "bv") if n in a))
        else:
            m = leaves["mamba"]
            mixer = Mamba(dense(m["in_proj"]), t(m["conv_w"]), t(m["conv_b"]),
                          dense(m["x_proj"]), dense(m["dt_proj"]), t(m["A_log"]),
                          t(m["D"]), dense(m["out_proj"]))
        ffn = None
        if "moe" in leaves:
            e = leaves["moe"]
            ffn = MoE(t(e["router"]), t(e["wi"]), t(e["wg"]), t(e["wo"]),
                      mlp(e["shared"]) if "shared" in e else None)
        elif "ffn" in leaves:
            ffn = mlp(leaves["ffn"])
        blocks.append(transformer.Block(kind, norm(leaves["norm1"]), mixer,
                                        norm(leaves["norm2"]), ffn))
    return transformer.LM(
        t(params_np["embed"]), norm(params_np["final_norm"]), blocks,
        dense(params_np["lm_head"]) if "lm_head" in params_np else None,
        t(params_np["pos_embed"]) if "pos_embed" in params_np else None)
