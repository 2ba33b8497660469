"""The language model's weights, made by the benchmark on the device from
``--seed`` and handed to both the port and the plain reference.

One draw of standard normals on the device for every weight at once (a
``torch.Generator`` on the card), then each weight is a view of it,
scaled in place: no weight is drawn leaf by leaf or on the host.  The
names and layouts are the port's (a dense weight ``[d_in, d_out]``, the
attention's ``wq [D, H, dh]``, ``wk``/``wv [D, KV, dh]``, ``wo [H, dh,
D]``); ``to_program`` builds the port's model object from the same
tensors, so the two sides share every weight bit for bit.
"""
from __future__ import annotations

import torch

from perfbench import datagen


def layout(cfg: dict) -> list[tuple[str, tuple, float, float]]:
    """(name, shape, scale, shift) of every weight: a weight is
    ``shift + scale * N(0, 1)``.  Norm scales sit near 1 and every bias is
    small but not zero, so each is exercised."""
    D, H, KV, F, V = (cfg[k] for k in ("d_model", "n_heads", "n_kv_heads", "d_ff",
                                       "vocab_size"))
    dh = D // H
    out = [("embed", (V, D), 1.0, 0.0)]
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        out += [(p + "norm1.scale", (D,), 0.02, 1.0), (p + "norm1.bias", (D,), 0.02, 0.0),
                (p + "wq", (D, H, dh), D ** -0.5, 0.0), (p + "wk", (D, KV, dh), D ** -0.5, 0.0),
                (p + "wv", (D, KV, dh), D ** -0.5, 0.0),
                (p + "wo", (H, dh, D), (H * dh) ** -0.5, 0.0)]
        if cfg["qkv_bias"]:
            out += [(p + "bq", (H, dh), 0.02, 0.0), (p + "bk", (KV, dh), 0.02, 0.0),
                    (p + "bv", (KV, dh), 0.02, 0.0)]
        out += [(p + "norm2.scale", (D,), 0.02, 1.0), (p + "norm2.bias", (D,), 0.02, 0.0),
                (p + "wi", (D, F), D ** -0.5, 0.0), (p + "wo_mlp", (F, D), F ** -0.5, 0.0)]
    out += [("final_norm.scale", (D,), 0.02, 1.0), ("final_norm.bias", (D,), 0.02, 0.0),
            ("lm_head", (D, V), D ** -0.5, 0.0)]
    return out


def make(cfg: dict, seed: int, device) -> dict:
    """Every weight of ``cfg`` (the configuration file's keys) in float32
    on ``device``, as views of one seeded draw."""
    lay = layout(cfg)
    total = sum(torch.Size(s).numel() for _, s, _, _ in lay)
    gen = torch.Generator(device=device).manual_seed(datagen.torch_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, scale, shift in lay:
        n = torch.Size(shape).numel()
        t = flat[off:off + n].view(shape).mul_(scale)
        if shift:
            t.add_(shift)
        out[name] = t
        off += n
    return out


def to_program(W: dict, cfg: dict):
    """The port's model (``repro_torch.models.transformer.LM``) over the
    tensors ``W``, through its public constructors."""
    from repro_torch.models.attention import Attention
    from repro_torch.models.layers import MLP, Dense, Norm
    from repro_torch.models.transformer import LM, Block
    eps = cfg["norm_eps"]

    def norm(p):
        return Norm(cfg["norm"], eps, W[p + ".scale"], W[p + ".bias"])

    blocks = []
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}."
        bias = ([W[p + "bq"], W[p + "bk"], W[p + "bv"]] if cfg["qkv_bias"] else [])
        blocks.append(Block("attn", norm(p + "norm1"),
                            Attention(W[p + "wq"], W[p + "wk"], W[p + "wv"], W[p + "wo"], *bias),
                            norm(p + "norm2"),
                            MLP(Dense(W[p + "wi"]), Dense(W[p + "wo_mlp"]))))
    return LM(W["embed"], norm("final_norm"), blocks, Dense(W["lm_head"]))
