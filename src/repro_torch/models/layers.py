"""Shared neural-net layers (port of ``repro/models/layers.py``).

Weights keep the JAX package's layouts (a dense weight is ``[d_in, d_out]``
and applies as ``x @ w``), so a parameter tree converts leaf for leaf
(models/convert.py).  Norms and rotary embeddings compute in float32 and
return the input's dtype, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.tp import ONE


def truncated_normal(shape, scale: float, dtype, *, generator: torch.Generator,
                     device=None) -> torch.Tensor:
    """``scale`` times a standard normal truncated to [-2, 2] (the
    reference's ``jax.random.truncated_normal(key, -2, 2)``), drawn from an
    explicit generator on its device.  The numbers differ from JAX's for the
    same seed; tests convert the JAX init instead (models/convert.py).
    Scaled in place: one f32 copy of the tensor beside the result (grok-1's
    [8, 6144, 32768] expert weights are 6.4 GB in f32)."""
    device = generator.device if device is None else device
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale).to(dtype)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    # parameters are made frozen, as serving wants them; training turns
    # every one on with ``models.model.trainable``
    return nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """``y = x @ w (+ b)`` (applied by ``dense``); w: [d_in, d_out]."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = _frozen(w)
        self.b = None if b is None else _frozen(b)

    @classmethod
    def init(cls, d_in, d_out, dtype, *, generator, device=None):
        return cls(truncated_normal((d_in, d_out), d_in ** -0.5, dtype,
                                    generator=generator, device=device))


def dense(w, b, x):
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def dense_col(d, x, tp, sharded: bool):
    """A column-parallel ``Dense`` (or a view of one) on x: this rank's
    output columns, its replicated bias cut to them (``TP.cols``)."""
    return dense(d.w, tp.cols(d.b, d.w.shape[-1], sharded), x)


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale`` and ``bias``)."""

    def __init__(self, kind: str, eps: float, scale: torch.Tensor,
                 bias: torch.Tensor | None = None):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm"):
            raise ValueError(kind)
        self.kind, self.eps = kind, eps
        self.scale = _frozen(scale)
        self.bias = None if bias is None else _frozen(bias)

    @classmethod
    def init(cls, d, kind, eps, dtype, device):
        ones = torch.ones((d,), dtype=dtype, device=device)
        bias = torch.zeros((d,), dtype=dtype, device=device) \
            if kind == "layernorm" else None
        return cls(kind, eps, ones, bias)


def norm(n, x, tp=None):
    """The norm ``n`` (a ``Norm``, or dist/parallel.py's view of one) on x;
    on a slice of the sequence (``tp.sp``) its weights pass through
    copy-to."""
    if tp is None:
        return apply_norm(n.scale, n.bias, x, n.kind, n.eps)
    return apply_norm(tp.rep(n.scale, False), tp.rep(n.bias, False), x, n.kind, n.eps)


def apply_norm(scale, bias, x, kind: str, eps: float):
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    elif kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


# ---- rotary position embeddings -------------------------------------------
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    # theta stays a Python scalar: a tensor made from it on the card would
    # be a host-to-device copy, which waits for the stream (twice a layer)
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., s, d]; pos: broadcastable to [..., s].  Split halves (the
    reference's ``layers.py:57-65``), not interleaved pairs."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # [d/2]
    ang = pos[..., None].float() * freqs                    # [..., s, d/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int) -> np.ndarray:
    """[n, d] float32: sin on the even columns, cos on the odd ones, at
    angles ``pos / 10000 ** (2i / d)`` worked out in float64 (the
    reference's ``layers.py:68-75``; whisper's encoder positions)."""
    pos = np.arange(n)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / 10_000 ** (dim / d)
    out = np.zeros((n, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


# ---- MLPs -------------------------------------------------------------------
class MLP(nn.Module):
    """Gated (SwiGLU: ``silu(x wg) * (x wi)``) or classic GELU MLP."""

    def __init__(self, wi: Dense, wo: Dense, wg: Dense | None = None):
        super().__init__()
        self.wi, self.wo, self.wg = wi, wo, wg

    @classmethod
    def init(cls, d, f, dtype, *, generator, device=None, gated=True):
        mk = lambda a, b: Dense.init(a, b, dtype, generator=generator,
                                     device=device)
        wi = mk(d, f)
        wg = mk(d, f) if gated else None
        return cls(wi, mk(f, d), wg)


def mlp_apply(p, x, tp=None):
    """The MLP ``p`` (an ``MLP`` or a view of one) on x, its hidden dim
    split over 'model' where the table splits it: ``wi``/``wg`` column-
    parallel, ``wo`` row-parallel (one reduction, its bias added after
    it, in the one-device ``h @ wo + b`` order)."""
    tp = tp or ONE
    sh = tp.sharded(p)
    x = tp.enter(x, sh)
    col = lambda d: (lambda h: dense_col(d, h, tp, sh))
    a = mlp_hidden(x, col(p.wi), None if p.wg is None else col(p.wg))
    y = tp.leave(dense(p.wo.w, None, a), sh)
    b = tp.rep(p.wo.b, False)
    return y if b is None else y + b.to(y.dtype)


def mlp_hidden(x, wi, wg=None):
    """An MLP's hidden activations, ``wi`` and ``wg`` mapping ``x`` to the
    hidden width: ``silu(wg(x)) * wi(x)`` gated, else ``gelu(wi(x))``
    (tanh form, ``jax.nn.gelu``'s default)."""
    if wg is not None:
        return F.silu(wg(x)) * wi(x)
    return F.gelu(wi(x), approximate="tanh")
