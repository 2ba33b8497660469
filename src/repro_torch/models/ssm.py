"""Mamba (selective SSM) block, jamba's sequence mixer (port of
``repro/models/ssm.py``).

Forward: a causal depthwise convolution summed over the kernel's shifted
slices in the reference's order, then a chunked selective scan: chunks of
``L = min(chunk, s)`` steps one after another, each an inclusive scan of
``h' = dA * h + dBx`` in float32 carried from the previous chunk's last
state.  The reference scans a chunk with ``associative_scan``; the port
uses the log-step (Hillis-Steele) form of the same combine, ``log2(L)``
passes of elementwise torch ops over the chunk, so a chunk costs a few
dozen launches instead of ``L`` sequential steps.  Decode: the one-step
recurrence with a ``[b, kc - 1, di]`` convolution window in the compute
dtype and the state ``h`` [b, di, n] in float32, as the reference caches
them.  The reference has no Pallas kernel here.

On a {data, model} mesh (``tp``, dist/tp.py) each rank runs the
convolution, the scan, ``dt_proj``, ``A_log`` and ``D`` on its contiguous
slice of d_inner, as the rule table splits them; ``x_proj`` is row-
parallel (its [b, s, r + 2n] product summed over 'model' before the
split) and so is ``out_proj`` (one reduction).  ``in_proj`` [D, 2 di] is
column-parallel over the *fused* x | z, so at two ranks rank 0 holds all
of x and rank 1 all of z, while each needs both at its own channels.  The
port regroups the local product [b, s, 2 di / tp] with one all-to-all
(``collectives.regroup_halves``), not the weight: a rank then moves
b * s * 2 di / tp activations (16 MB a layer at b=2 x 2048 on the 16-way
model axis of jamba's production mesh) where gathering the weight shard
would move D * 2 di, 268 MB a layer, whatever the batch; and the
product stays 1/tp of the work.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.tp import ONE
from repro_torch.models.layers import Dense, _frozen, dense, dense_col, truncated_normal


def _dt_rank(cfg) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0); F.softplus turns linear above 20
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


class Mamba(nn.Module):
    """``in_proj`` [D, 2 di], ``conv_w`` [kc, di], ``conv_b`` [di],
    ``x_proj`` [di, r + 2n], ``dt_proj`` [r, di] with its bias, float32
    ``A_log`` [di, n] and ``D`` [di], ``out_proj`` [di, D]."""

    def __init__(self, in_proj: Dense, conv_w, conv_b, x_proj: Dense, dt_proj: Dense,
                 A_log, D, out_proj: Dense):
        super().__init__()
        self.in_proj, self.x_proj, self.dt_proj, self.out_proj = (
            in_proj, x_proj, dt_proj, out_proj)
        self.conv_w, self.conv_b, self.A_log, self.D = map(_frozen, (conv_w, conv_b, A_log, D))

    @classmethod
    def init(cls, cfg, dtype, *, generator, device=None):
        D_ = cfg.d_model
        di, n, kc, r = cfg.ssm_expand * D_, cfg.ssm_state, cfg.ssm_conv, _dt_rank(cfg)
        kw = dict(generator=generator, device=device)
        dev = generator.device if device is None else device
        zeros = lambda: torch.zeros((di,), dtype=dtype, device=dev)
        dt_proj = Dense(truncated_normal((r, di), r ** -0.5, dtype, **kw), zeros())
        A = torch.arange(1, n + 1, dtype=torch.float32, device=dev).repeat(di, 1)
        return cls(Dense.init(D_, 2 * di, dtype, **kw),
                   truncated_normal((kc, di), kc ** -0.5, dtype, **kw),
                   zeros(), Dense.init(di, r + 2 * n, dtype, **kw), dt_proj,
                   torch.log(A), torch.ones((di,), dtype=torch.float32, device=dev),
                   Dense.init(di, D_, dtype, **kw))


def _ssm_params(p: Mamba, cfg, xc, tp=None, sharded: bool = False):
    """xc: [..., di] post-conv activations (this rank's channels on a
    mesh) -> (dt, B, C) in float32, dt on the same channels.  ``x_proj``
    is row-parallel there: its product is summed over 'model' before the
    split, and ``dt_proj`` column-parallel."""
    tp = tp or ONE
    n, r = cfg.ssm_state, _dt_rank(cfg)
    y = tp.psum(dense(p.x_proj.w, None, xc), sharded)
    if p.x_proj.b is not None:
        y = y + tp.rep(p.x_proj.b, sharded).to(y.dtype)
    dt, Bm, Cm = y.split([r, n, n], dim=-1)
    dt = dense_col(p.dt_proj, dt, tp, sharded)
    return _softplus(dt.float()), Bm.float(), Cm.float()


def _scan_chunk(a, u):
    """Inclusive scan of ``h' = a * h + u`` along axis 1 from h = 0; returns
    (cumulative a, h).  Step d combines each position with the one d before
    it: (a_l * a, a * u_l + u).  In place of ``a`` and ``u``, unless
    autograd records them: the backward needs the values each step read,
    so then every step makes new tensors (the same numbers, and a copy of
    the whole chunk more a step, which serving does not pay)."""
    inplace = not (torch.is_grad_enabled() and (a.requires_grad or u.requires_grad))
    L, d = a.shape[1], 1
    while d < L:
        if inplace:
            u[:, d:] += a[:, d:] * u[:, :-d]
            a[:, d:] = a[:, d:] * a[:, :-d]
        else:
            u = torch.cat([u[:, :d], u[:, d:] + a[:, d:] * u[:, :-d]], dim=1)
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, u


def mamba_apply(p: Mamba, cfg, x: torch.Tensor, *, chunk: int = 256, tp=None) -> torch.Tensor:
    """x: [b, s, D] -> [b, s, D] (causal).  On a mesh (``tp``) the
    convolution, the scan and ``D`` run on this rank's channels of d_inner
    (``p``'s weights as the table splits them)."""
    tp = tp or ONE
    sh = tp.sharded(p)
    b, s, _ = x.shape
    di, n, kc = p.conv_w.shape[-1], cfg.ssm_state, cfg.ssm_conv
    xi, z = _in_proj(p, tp.enter(x, sh), tp, sh)                   # [b, s, di]

    # causal depthwise conv along s: the reference's sum of shifted slices
    pad = F.pad(xi, (0, 0, kc - 1, 0))
    xc = sum(pad[:, i:i + s] * p.conv_w[i].to(x.dtype) for i in range(kc))
    xc = F.silu(xc + p.conv_b.to(x.dtype))

    dt, Bm, Cm = _ssm_params(p, cfg, xc, tp, sh)        # [b,s,di], [b,s,n] x2
    A = -torch.exp(p.A_log)                                         # [di, n]
    xcf = xc.float()

    L = min(chunk, s)
    h = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, L):
        # the last chunk is shorter where the reference pads it: a padded
        # step has dt = 0 (dA = 1, dBx = 0) and is cut from y
        dt_, B_, C_, x_ = (t[:, c0:c0 + L] for t in (dt, Bm, Cm, xcf))
        dA = (dt_[..., None] * A).exp_()                            # [b, L, di, n]
        dBx = (dt_ * x_)[..., None] * B_[:, :, None, :]
        aa, hs = _scan_chunk(dA, dBx)
        hs += aa * h[:, None]
        ys.append(torch.einsum("blin,bln->bli", hs, C_))
        h = hs[:, -1].clone()
        del dA, dBx, aa, hs
    y = torch.cat(ys, dim=1) + xcf * p.D
    y = y.to(x.dtype) * F.silu(z)
    return _out_proj(p, y, tp, sh)


def _in_proj(p: Mamba, x, tp, sharded: bool):
    """``in_proj`` (column-parallel over the fused x | z) -> this rank's
    channels of x and of z (``TP.halves``: the local product regrouped by
    one all-to-all)."""
    return tp.halves(dense_col(p.in_proj, x, tp, sharded), sharded)


def _out_proj(p: Mamba, y, tp, sharded: bool):
    """``out_proj``, row-parallel: one reduction, then its bias."""
    out = tp.leave(dense(p.out_proj.w, None, y), sharded)
    b = tp.rep(p.out_proj.b, False)
    return out if b is None else out + b.to(out.dtype)


def mamba_init_cache(cfg, batch: int, dtype, device) -> dict:
    di = cfg.ssm_expand * cfg.d_model
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype, device=device),
            "h": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32,
                             device=device)}


def mamba_decode(p: Mamba, cfg, x1: torch.Tensor, cache: dict, tp=None):
    """x1: [b, 1, D] -> (y1, new cache); O(1) per token.  On a mesh the
    cache holds this rank's channels of d_inner (``cache_pspecs`` splits
    the window and the state along d_inner, as the weights)."""
    tp = tp or ONE
    sh = tp.sharded(p)
    if cache["h"].shape[1] != p.conv_w.shape[-1]:
        raise ValueError(f"the Mamba cache holds {cache['h'].shape[1]} channels of d_inner, "
                         f"the weights {p.conv_w.shape[-1]}")
    xi, z = _in_proj(p, tp.enter(x1, sh), tp, sh)                  # [b, 1, di]
    window = torch.cat([cache["conv"], xi], dim=1)                  # [b, kc, di]
    xc = (window * p.conv_w.to(x1.dtype)[None]).sum(1, keepdim=True) \
        + p.conv_b.to(x1.dtype)
    xc = F.silu(xc)

    dt, Bm, Cm = _ssm_params(p, cfg, xc, tp, sh)                    # [b, 1, ...]
    A = -torch.exp(p.A_log)
    dA = torch.exp(dt[..., None] * A)[:, 0]                         # [b, di, n]
    dBx = ((dt * xc.float())[..., None] * Bm[:, :, None, :])[:, 0]
    h = dA * cache["h"] + dBx
    y = torch.einsum("bin,bn->bi", h, Cm[:, 0])[:, None, :]
    y = (y + xc.float() * p.D).to(x1.dtype) * F.silu(z)
    return _out_proj(p, y, tp, sh), {"conv": window[:, 1:], "h": h}
