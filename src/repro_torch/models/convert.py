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

The other way, ``reference_layout`` gives each named parameter of the
port's model its key path in the reference's tree and its index along the
stacked period axis, and ``to_reference_tree`` / ``from_reference_tree``
stack any values keyed by parameter name (the weights, their gradients,
the optimizer's moments) into that tree and take them out again.
``params_to_tree`` is the inverse of ``params_from_jax``.  Training keys
its weight decay by these paths and writes its checkpoints in this tree,
so a checkpoint is the reference's leaf for leaf.
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


# the reference's key of a block's mixer, by block kind
_MIXER_KEY = {"attn": "attn", "attn_moe": "attn", "mamba": "mamba", "mamba_moe": "mamba",
              "mlstm": "mlstm", "slstm": "slstm"}


def reference_layout(params, cfg: ArchConfig) -> dict:
    """{parameter name: (key path in the reference's tree, index along its
    stacked period axis or None)} for every named parameter of ``params``
    (a ``transformer.LM`` or an ``encdec.EncDec``).  A path holds dict keys
    and, under ``blocks``, the position ``j`` in the block pattern."""
    n = len(cfg.block_pattern)
    out = {}
    for name, _ in params.named_parameters():
        parts = name.split(".")
        if parts[0] in ("enc_blocks", "dec_blocks"):
            out[name] = ((parts[0], *parts[2:]), int(parts[1]))
        elif parts[0] == "blocks":
            layer = int(parts[1])
            kind = cfg.block_pattern[layer % n]
            key = {"mixer": _MIXER_KEY[kind],
                   "ffn": "moe" if kind.endswith("_moe") else "ffn"}.get(parts[2], parts[2])
            out[name] = (("blocks", layer % n, key, *parts[3:]), layer // n)
        else:
            out[name] = (tuple(parts), None)
    return out


def path_str(path: tuple) -> str:
    """A key path as the reference's optimizer spells it: its keys and
    list positions joined by ``/`` (``blocks/0/attn/bq``)."""
    return "/".join(str(k) for k in path)


def _lists(node):
    """Nested dicts with the int keys of the block pattern turned into lists."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[j]) for j in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def to_reference_tree(values: dict, layout: dict, *, device=None):
    """``values`` ({parameter name: tensor}) as the reference's tree: nested
    dicts, ``blocks`` a list by pattern position, each stacked leaf the
    periods' tensors stacked on a new axis 0.  Leaves are detached and, with
    ``device``, moved there first (the CPU, to stack a large model's state
    off the card)."""
    root: dict = {}
    stacks: dict = {}
    for name, (path, idx) in layout.items():
        t = values[name].detach()
        t = t if device is None else t.to(device)
        if idx is None:
            node = root
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        else:
            stacks.setdefault(path, {})[idx] = t
    for path, by_idx in stacks.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.stack([by_idx[i] for i in range(len(by_idx))])
    return _lists(root)


def from_reference_tree(tree, layout: dict) -> dict:
    """The inverse of ``to_reference_tree``: {parameter name: its tensor},
    a stacked leaf's slice (a view) for a stacked parameter."""
    out = {}
    for name, (path, idx) in layout.items():
        node = tree
        for k in path:
            node = node[k]
        out[name] = node if idx is None else node[idx]
    return out


def params_to_tree(params, cfg: ArchConfig, *, device=None):
    """The port's model as the reference's parameter tree (tensors): the
    inverse of ``params_from_jax``."""
    return to_reference_tree(dict(params.named_parameters()),
                             reference_layout(params, cfg), device=device)
