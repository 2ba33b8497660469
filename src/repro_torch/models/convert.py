"""Carry a JAX parameter tree into the port's modules.

``params_from_jax`` takes the tree of ``repro.models.model.init_params`` as
numpy arrays (``jax.tree.map(np.asarray, params)``: this module imports no
JAX) and unstacks the ``[n_periods, ...]`` block leaves of the reference's
layer scan into one port block per layer: layer ``p * len(pattern) + j``
is ``blocks[j]`` at index ``p`` (reference ``transformer.py:68-74``).  An
enc-dec tree's ``enc_blocks`` and ``dec_blocks`` are stacked with the
layer on axis 0 (reference ``encdec.py:49-55``).  Every leaf keeps its
dtype, so the leaves the reference makes float32 whatever the parameter
dtype (the MoE router, Mamba's ``A_log``/``D``, the xLSTM gates, biases,
recurrence and norms) stay float32.  bfloat16 leaves (``ml_dtypes``, known here by the dtype's name) are read
through their 16-bit patterns, as ``dist/checkpoint.py`` reads them.  Like
every entry point of the port, it puts the weights on the card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.smtree import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Dense, Norm
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import Mamba
from repro_torch.models.xlstm import MLSTM, SLSTM


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _at(tree, i):
    """The leaves at index ``i`` of a stacked subtree."""
    return {k: _at(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def params_from_jax(params_np: dict, cfg: ArchConfig, *, device=None):
    """-> a ``transformer.LM`` or, for an enc-dec config, an
    ``encdec.EncDec``."""
    device = resolve_device(device)
    t = lambda a: _tensor(a, device)
    norm = lambda p, kind=cfg.norm, eps=cfg.norm_eps: Norm(
        kind, eps, t(p["scale"]), t(p["bias"]) if "bias" in p else None)
    dense = lambda p: Dense(t(p["w"]), t(p["b"]) if "b" in p else None)
    mlp = lambda f: MLP(dense(f["wi"]), dense(f["wo"]), dense(f["wg"]) if "wg" in f else None)
    attn = lambda a: Attention(t(a["wq"]), t(a["wk"]), t(a["wv"]), t(a["wo"]),
                               *(t(a[n]) for n in ("bq", "bk", "bv") if n in a))
    if cfg.is_encdec:
        enc = [_at(params_np["enc_blocks"], i) for i in range(cfg.encoder_layers)]
        dec = [_at(params_np["dec_blocks"], i) for i in range(cfg.n_layers)]
        return encdec.EncDec(
            t(params_np["embed"]), t(params_np["dec_pos"]),
            [encdec.EncDecBlock(norm(b["norm1"]), attn(b["attn"]), norm(b["norm2"]),
                                mlp(b["ffn"])) for b in enc],
            [encdec.EncDecBlock(norm(b["norm1"]), attn(b["attn"]), norm(b["norm2"]),
                                mlp(b["ffn"]), norm(b["normx"]), attn(b["xattn"]))
             for b in dec],
            norm(params_np["enc_norm"]), norm(params_np["final_norm"]))

    rms = lambda p: norm(p, "rmsnorm", 1e-5)       # the xLSTM blocks' own norms
    pattern = cfg.block_pattern
    blocks = []
    for layer in range(cfg.n_layers):
        kind = pattern[layer % len(pattern)]
        leaves = _at(params_np["blocks"][layer % len(pattern)], layer // len(pattern))
        if kind == "mlstm":
            m = leaves["mlstm"]
            blocks.append(transformer.Block(kind, norm(leaves["norm1"]), MLSTM(
                dense(m["up"]), t(m["conv_w"]), t(m["conv_b"]), dense(m["wq"]),
                dense(m["wk"]), dense(m["wv"]), t(m["w_if"]), t(m["b_if"]),
                dense(m["w_o"]), rms(m["outnorm"]), dense(m["down"])), None, None))
            continue
        if kind == "slstm":
            m = leaves["slstm"]
            blocks.append(transformer.Block(kind, norm(leaves["norm1"]), SLSTM(
                t(m["w"]), t(m["b"]), t(m["r"]), rms(m["gnorm"]), dense(m["up"]),
                dense(m["down"])), None, None))
            continue
        if kind.startswith("attn"):
            mixer = attn(leaves["attn"])
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
