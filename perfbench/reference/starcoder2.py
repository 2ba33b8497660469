"""A plain float32 forward of the starcoder2 decoder as the configuration
states it, over a whole sequence at once: no cache, no kernels, no
batching, and TF32 off (``tf32=True`` is the control's lower precision).

Pre-norm blocks: LayerNorm (scale and bias), grouped-query attention with
biases on q, k and v, rotary positions on split halves, causal softmax
attention scaled by ``dh ** -0.5``, no bias on the output projection; then
LayerNorm and a 2-matrix MLP with tanh GELU and no biases; a final
LayerNorm and an untied head.  The published starcoder2 also has biases
on the output projection and the MLP and a 4,096-token sliding window;
the configuration leaves out the biases, and the window never binds at
the benchmark's 257 positions.
"""
from __future__ import annotations

import contextlib
import math

import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def layer_norm(x, scale, bias, eps: float):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def rope(x, theta: float):
    """x: [T, heads, dh]; position t rotates pair (i, i + dh/2) by
    ``t / theta ** (2i / dh)``."""
    T, _, dh = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, device=x.device, dtype=torch.float32) / dh)
    ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def logits(W: dict, cfg: dict, tokens: torch.Tensor, *, tf32: bool = False) -> torch.Tensor:
    """Next-token logits [T, V] after each of the ``tokens`` [T] of one
    sequence."""
    D, H, KV = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    dh, eps, g = D // H, cfg["norm_eps"], H // KV
    T = tokens.shape[0]
    causal = torch.ones(T, T, dtype=torch.bool, device=tokens.device).tril()
    with matmul_precision(tf32):
        x = W["embed"][tokens.long()].float()
        for i in range(cfg["n_layers"]):
            p = f"layers.{i}."
            h = layer_norm(x, W[p + "norm1.scale"], W[p + "norm1.bias"], eps)
            q = (h @ W[p + "wq"].reshape(D, H * dh)).view(T, H, dh)
            k = (h @ W[p + "wk"].reshape(D, KV * dh)).view(T, KV, dh)
            v = (h @ W[p + "wv"].reshape(D, KV * dh)).view(T, KV, dh)
            if cfg["qkv_bias"]:
                q, k, v = q + W[p + "bq"], k + W[p + "bk"], v + W[p + "bv"]
            q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
            kh = k.repeat_interleave(g, dim=1)          # query head j reads kv head j // g
            vh = v.repeat_interleave(g, dim=1)
            s = torch.einsum("thd,shd->hts", q, kh) / math.sqrt(dh)
            a = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
            o = torch.einsum("hts,shd->thd", a, vh).reshape(T, H * dh)
            x = x + o @ W[p + "wo"].reshape(H * dh, D)
            h = layer_norm(x, W[p + "norm2.scale"], W[p + "norm2.bias"], eps)
            u = h @ W[p + "wi"]
            u = 0.5 * u * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (u + 0.044715 * u ** 3)))
            x = x + u @ W[p + "wo_mlp"]
        h = layer_norm(x, W["final_norm.scale"], W["final_norm.bias"], eps)
        return h @ W["lm_head"]
