"""Mixture-of-Experts FFN with capacity-based dispatch (port of
``repro/models/moe.py``).

Top-k routing in float32, per-expert capacity ``C = T * k / E *
capacity_factor`` with the overflow dropped (Switch/GShard semantics, the
dropped share reported in the aux), stacked expert SwiGLU weights ``[E,
...]`` multiplied over every expert at once, and qwen2-moe's shared
experts run densely for every token.  Decode passes ``capacity=b``, which
makes it dropless.

The reference has no Pallas kernel here: its expert products are plain
XLA ``einsum``s, so the port's are ``torch.bmm``.  Its expert-parallel
form (``moe_apply_ep``: an ``all_to_all`` over the mesh's data axis) needs
a process group and waits for ROADMAP Queue 1 item 14; without a mesh the
reference means ``moe_apply`` itself, which is what the port computes for
``cfg.moe_ep`` (the reference's own call recurses without end there).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import MLP, _frozen, truncated_normal


class MoE(nn.Module):
    """``router`` [D, E] (float32 whatever the parameter dtype), ``wi`` /
    ``wg`` [E, D, F], ``wo`` [E, F, D], and the optional gated ``shared``
    MLP of width ``F * n_shared_experts``; E is ``cfg.padded_experts``."""

    def __init__(self, router, wi, wg, wo, shared: MLP | None = None):
        super().__init__()
        self.router, self.wi, self.wg, self.wo = map(_frozen, (router, wi, wg, wo))
        self.shared = shared

    @classmethod
    def init(cls, cfg, dtype, *, generator, device=None):
        D, F_ = cfg.d_model, cfg.moe_d_ff or cfg.d_ff
        E = cfg.padded_experts
        tn = lambda shape, scale, dt=dtype: truncated_normal(
            shape, scale, dt, generator=generator, device=device)
        shared = (MLP.init(D, F_ * cfg.n_shared_experts, dtype, generator=generator,
                           device=device, gated=True) if cfg.n_shared_experts else None)
        return cls(tn((D, E), D ** -0.5, torch.float32), tn((E, D, F_), D ** -0.5),
                   tn((E, D, F_), D ** -0.5), tn((E, F_, D), F_ ** -0.5), shared)


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``'s order: descending, the lower index first on ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_apply(p: MoE, cfg, x: torch.Tensor, capacity: int | None = None, *,
              _routing: list | None = None):
    """x: [b, s, D] -> (y, aux) with aux = dict(lb_loss, z_loss, drop_frac).

    ``capacity`` overrides the per-expert buffer size (decode passes the
    batch: dropless).  ``_routing`` (private) gets one dict per call: the
    choices ``gate_i`` [T, k], whether each was kept, ``keep`` [T, k], and
    the three aux values, so a caller can compare two runs' routing."""
    b, s, D = x.shape
    E, k = cfg.padded_experts, cfg.experts_per_token
    T = b * s
    C = capacity or max(1, int(T * k / cfg.n_experts * cfg.capacity_factor))
    C = min(C, T)
    dt = x.dtype
    xf = x.reshape(T, D)

    logits = xf.float() @ p.router                                  # [T, E]
    if E != cfg.n_experts:          # padded experts never win routing
        pad = torch.arange(E, device=x.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, -1)
    gate_v, gate_i = _top_k(probs, k)                               # [T, k]
    gate_v = gate_v / gate_v.sum(-1, keepdim=True).clamp_min(1e-9)

    # each (token, choice)'s slot in its expert's buffer: token-major, then
    # by choice, as the reference's cumsum over the flattened one-hot (held
    # here as [E, T*k], so the scan runs along the inner dimension)
    e_idx = gate_i.reshape(-1)                                      # [T*k]
    flat = (torch.arange(E, device=x.device)[:, None] == e_idx).to(torch.int32)
    pos = flat.cumsum(1).gather(0, e_idx[None])[0] - 1
    keep = (pos < C) & (pos >= 0)
    c_idx = pos.clamp(0, C - 1)

    # dropped rows add zeros at the clipped slot, as ``buf.at[].add`` does
    src = xf.repeat_interleave(k, dim=0)
    buf = torch.zeros((E, C, D), dtype=dt, device=x.device)
    buf.index_put_((e_idx, c_idx), torch.where(keep[:, None], src, 0), accumulate=True)

    # expert SwiGLU over every expert at once
    h = F.silu(torch.bmm(buf, p.wg.to(dt))) * torch.bmm(buf, p.wi.to(dt))
    out_e = torch.bmm(h, p.wo.to(dt))                               # [E, C, D]

    picked = out_e[e_idx, c_idx]                                    # [T*k, D]
    w = (gate_v.reshape(-1, 1) * keep[:, None]).to(dt)
    y = (picked * w).reshape(T, k, D).sum(1).reshape(b, s, D)
    if p.shared is not None:
        y = y + p.shared(x)

    ce = flat.sum(1).float() / max(T * k, 1)
    aux = {"lb_loss": E * (probs.mean(0) * ce).sum(),
           "z_loss": (torch.logsumexp(logits, -1) ** 2).mean(),
           "drop_frac": 1.0 - keep.float().mean()}
    if _routing is not None:
        _routing.append(dict(gate_i=gate_i, keep=keep.reshape(T, k), **aux))
    return y, aux
