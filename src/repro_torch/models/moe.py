"""Mixture-of-Experts FFN with capacity-based dispatch (port of
``repro/models/moe.py``).

Top-k routing in float32, per-expert capacity ``C = T * k / E *
capacity_factor`` with the overflow dropped (Switch/GShard semantics, the
dropped share reported in the aux), stacked expert SwiGLU weights ``[E,
...]`` multiplied over every expert at once, and qwen2-moe's shared
experts run densely for every token.  Decode passes ``capacity=b``, which
makes it dropless.

The reference has no Pallas kernel here: its expert products are plain
XLA ``einsum``s, so the port's are ``torch.bmm``.  ``moe_apply_ep`` is the
expert-parallel form over a data group (``all_to_all_single``): each data
rank dispatches its own tokens at its own capacity ``Cg = ceil(min(C, T) /
G)`` to the ranks that hold their experts, as the reference's shard_map
body does, so its dropped set is the reference's EP one, not dense
``moe_apply``'s.  Both take a ``model_group`` when the experts' hidden dim
is split over it (tensor parallel): the dispatched buffer enters through
``copy_to`` and the expert outputs leave through ``reduce_from``.  Without
a group ``moe_apply`` is what the port computes for ``cfg.moe_ep`` (the
reference's own call recurses without end there).
"""
from __future__ import annotations

import types

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.collectives import (all_reduce_sum, all_to_all, copy_to, gather_stacked,
                                          reduce_from)
from repro_torch.models.layers import MLP, _frozen, mlp_apply, truncated_normal


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


def _experts(p, buf, model_group=None):
    """Expert SwiGLU over every expert of the buffer [E, C, D] at once,
    the hidden dim split over ``model_group`` when it is given."""
    dt = buf.dtype
    if model_group is not None:
        buf = copy_to(buf, model_group)
    h = F.silu(torch.bmm(buf, p.wg.to(dt))) * torch.bmm(buf, p.wi.to(dt))
    out_e = torch.bmm(h, p.wo.to(dt))
    return out_e if model_group is None else reduce_from(out_e, model_group)


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``'s order: descending, the lower index first on ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _route(p, cfg, xf: torch.Tensor):
    """Top-k routing of the tokens xf [T, D] in float32, shared by both
    dispatches: -> (logits [T, E], probs [T, E], gate_v [T, k] renormalised,
    gate_i [T, k], e_idx [T*k] the chosen experts token-major, flat [E, T*k]
    their one-hot, pos [T*k] each (token, choice)'s slot in its expert's
    buffer).  The slots count token-major, then by choice, as the
    reference's cumsum over the flattened one-hot (held here as [E, T*k],
    so the scan runs along the inner dimension)."""
    E, k = cfg.padded_experts, cfg.experts_per_token
    logits = xf.float() @ p.router                                  # [T, E]
    if E != cfg.n_experts:          # padded experts never win routing
        pad = torch.arange(E, device=xf.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, -1)
    gate_v, gate_i = _top_k(probs, k)                               # [T, k]
    gate_v = gate_v / gate_v.sum(-1, keepdim=True).clamp_min(1e-9)
    e_idx = gate_i.reshape(-1)                                      # [T*k]
    flat = (torch.arange(E, device=xf.device)[:, None] == e_idx).to(torch.int32)
    pos = flat.cumsum(1).gather(0, e_idx[None])[0] - 1
    return logits, probs, gate_v, gate_i, e_idx, flat, pos


def _dispatch(xf, k: int, e_idx, c_idx, keep, E: int, C: int):
    """The expert buffer [E, C, D]: each kept (token, choice) at its slot;
    dropped rows add zeros at the clipped slot, as ``buf.at[].add`` does."""
    src = xf.repeat_interleave(k, dim=0)
    buf = torch.zeros((E, C, xf.shape[1]), dtype=xf.dtype, device=xf.device)
    return buf.index_put((e_idx, c_idx), torch.where(keep[:, None], src, 0), accumulate=True)


def _combine(out_e, gate_v, e_idx, c_idx, keep, k: int):
    """Each token's kept choices' expert outputs, weighted by their gates
    and summed: -> [T, D]."""
    picked = out_e[e_idx, c_idx]                                    # [T*k, D]
    w = (gate_v.reshape(-1, 1) * keep[:, None]).to(out_e.dtype)
    return (picked * w).reshape(-1, k, out_e.shape[-1]).sum(1)


def moe_apply(p: MoE, cfg, x: torch.Tensor, capacity: int | None = None, *,
              model_group=None, data_group=None, tp=None, _routing: list | None = None):
    """x: [b, s, D] -> (y, aux) with aux = dict(lb_loss, z_loss, drop_frac).

    ``capacity`` overrides the per-expert buffer size (decode passes the
    batch: dropless).  ``model_group``: the group over which the experts'
    hidden dim is split (``p``'s ``wi``/``wg``/``wo`` hold this rank's
    slice).  ``data_group``: ``x`` is this rank's rows of a batch split
    evenly over the group, rank order; the dispatch is the whole batch's
    (the capacity from its token count, each slot counted after the lower
    ranks' tokens, as the reference's GSPMD program places them) and the
    aux values are its global means.  ``tp`` (dist/tp.py): the mesh context
    of the shared experts' MLP.  ``_routing`` (private) gets one dict
    per call: the choices ``gate_i`` [T, k], whether each was kept,
    ``keep`` [T, k], and the three aux values, so a caller can compare two
    runs' routing."""
    b, s, D = x.shape
    E, k = cfg.padded_experts, cfg.experts_per_token
    T = b * s
    Tg = T * (1 if data_group is None else dist.get_world_size(data_group))
    C = capacity or max(1, int(Tg * k / cfg.n_experts * cfg.capacity_factor))
    C = min(C, Tg)
    xf = x.reshape(T, D)
    logits, probs, gate_v, gate_i, e_idx, flat, pos = _route(p, cfg, xf)
    if data_group is None:
        keep = (pos < C) & (pos >= 0)
        c_idx = pos.clamp(0, C - 1)
    else:
        # the lower data ranks' tokens come first; a kept slot's local
        # position is below min(C, T), which sizes this rank's buffer
        counts = gather_stacked(flat.sum(1), data_group)            # [G, E]
        offset = counts[:dist.get_rank(data_group)].sum(0)[e_idx]
        keep = (pos + offset < C) & (pos >= 0)
        C = min(C, T)
        c_idx = pos.clamp(0, C - 1)

    buf = _dispatch(xf, k, e_idx, c_idx, keep, E, C)
    out_e = _experts(p, buf, model_group)                           # [E, C, D]
    y = _combine(out_e, gate_v, e_idx, c_idx, keep, k).reshape(b, s, D)
    if p.shared is not None:
        y = y + mlp_apply(p.shared, x, tp)

    if data_group is None:
        ce = flat.sum(1).float() / max(T * k, 1)
        aux = {"lb_loss": E * (probs.mean(0) * ce).sum(),
               "z_loss": (torch.logsumexp(logits, -1) ** 2).mean(),
               "drop_frac": 1.0 - keep.float().mean()}
    else:
        ce = counts.sum(0).float() / max(Tg * k, 1)
        me = all_reduce_sum(probs.sum(0), data_group) / Tg
        z = all_reduce_sum((torch.logsumexp(logits, -1) ** 2).sum(), data_group) / Tg
        kept = all_reduce_sum(keep.float().sum(), data_group)
        aux = {"lb_loss": E * (me * ce).sum(), "z_loss": z,
               "drop_frac": 1.0 - kept.detach() / (Tg * k)}
    if _routing is not None:
        _routing.append(dict(gate_i=gate_i, keep=keep.reshape(T, k), **aux))
    return y, aux


def _ambient_data_group():
    """The 'data' group of the ambient ``DeviceMesh``, or None."""
    from repro_torch.dist.sharding import _ambient_mesh
    mesh = _ambient_mesh()
    if mesh is None or "data" not in (getattr(mesh, "mesh_dim_names", None) or ()):
        return None
    return mesh.get_group("data")


def ep_applies(cfg, global_batch: int, group) -> bool:
    """Whether ``moe_apply_ep`` dispatches over ``group`` rather than
    falling back to ``moe_apply`` (the reference's test: a mesh, a data
    axis of more than one rank that divides the batch and the experts)."""
    if group is None:
        return False
    G = dist.get_world_size(group)
    return G > 1 and global_batch % G == 0 and cfg.padded_experts % G == 0


def moe_apply_ep(p, cfg, x: torch.Tensor, capacity: int | None = None, *, group=None,
                 model_group=None, tp=None):
    """Expert parallelism over the data group ``group`` (the reference's
    shard_map body, ``repro/models/moe.py:moe_apply_ep``).  ``x`` [b/G, s,
    D] is this rank's tokens; ``p``'s ``wi``/``wg`` [E/G, D, F] and ``wo``
    [E/G, F, D] are this rank's experts (E/G of them, rank ``r`` holding
    experts ``r * E/G ...``), the router [D, E] whole.  Where the reference
    falls back to dense ``moe_apply`` (``ep_applies`` false: no group, one
    rank, a batch or an expert count that G does not divide) ``p`` holds
    every expert and ``x`` every row, and ``moe_apply`` runs.

    Each rank routes its own tokens, places them at its own capacity
    ``Cg = ceil(min(C, T) / G)`` (C from the global T), sends each expert's
    block to the rank holding it (``all_to_all``: [E, Cg, D] -> [E/G, G*Cg,
    D]), runs its experts (the hidden dim over ``model_group``, if given)
    and sends the outputs back.  The aux values are the mean over the data
    ranks of each rank's own (the reference's ``aux.mean(0)``), the load
    balance counted against ``cfg.n_experts``, as its body does.  With no
    ``group``, the data group of the ambient mesh (``dist.sharding.
    use_mesh``), as the reference reads its ambient mesh."""
    if group is None:
        group = _ambient_data_group()
    b, s, D = x.shape
    G = 1 if group is None else dist.get_world_size(group)
    if not ep_applies(cfg, b * G, group):
        return moe_apply(p, cfg, x, capacity, model_group=model_group, tp=tp)
    E, k = cfg.padded_experts, cfg.experts_per_token
    T = b * G * s
    C = capacity or max(1, int(T * k / cfg.n_experts * cfg.capacity_factor))
    Cg = max(1, -(-min(C, T) // G))
    Tl = b * s
    xf = x.reshape(Tl, D)
    logits, probs, gate_v, _, e_idx, flat, pos = _route(p, cfg, xf)
    keep = pos < Cg
    c_idx = pos.clamp(0, Cg - 1)
    buf = _dispatch(xf, k, e_idx, c_idx, keep, E, Cg)
    # dispatch: expert block j to rank j, received blocks in rank order
    El = E // G
    buf = all_to_all(buf, group)                                    # [G, El, Cg, D] as [E, ...]
    buf = buf.reshape(G, El, Cg, D).transpose(0, 1).reshape(El, G * Cg, D)
    out_e = _experts(p, buf, model_group)                           # [El, G*Cg, D]
    # combine: each rank's slots back to it
    out_e = out_e.reshape(El, G, Cg, D).transpose(0, 1).reshape(E, Cg, D)
    out_e = all_to_all(out_e, group)
    y = _combine(out_e, gate_v, e_idx, c_idx, keep, k).reshape(b, s, D)
    ce = flat.sum(1).float() / max(Tl * k, 1)
    aux = torch.stack([cfg.n_experts * (probs.mean(0) * ce).sum(),
                       (torch.logsumexp(logits, -1) ** 2).mean(),
                       1.0 - keep.float().mean()])
    aux = all_reduce_sum(aux, group) / torch.full((), float(G), device=aux.device)
    if p.shared is not None:
        y = y + mlp_apply(p.shared, x, tp)
    return y, dict(zip(("lb_loss", "z_loss", "drop_frac"), aux.unbind()))


def moe_block(p, cfg, h: torch.Tensor, capacity: int | None = None, tp=None,
              _routing: list | None = None):
    """A block's MoE FFN.  On one device ``moe_apply``.  On a mesh (``tp``,
    dist/tp.py; h whole over 'model'): expert-parallel over 'data'
    (``moe_apply_ep``, each rank's own experts, not gathered) where the
    config and the batch allow it, else the whole batch's dense dispatch
    (``moe_apply(data_group=)``) with every expert gathered; the experts'
    hidden dim over 'model' either way.  Decode's dropless capacity is
    local; training's is the batch's."""
    if tp is None or tp.r is None:
        return moe_apply(p, cfg, h, capacity, _routing=_routing)
    r = tp.r
    model_group = r.model if tp.split(p, "wi") else None
    ep = (cfg.moe_ep and capacity is None and tp.rows_split
          and ep_applies(cfg, h.shape[0] * r.dp, r.data))
    if ep:
        q = types.SimpleNamespace(router=p.router, wi=p._raw("wi"), wg=p._raw("wg"),
                                  wo=p._raw("wo"), shared=p.shared)
        return moe_apply_ep(q, cfg, h, capacity, group=r.data, model_group=model_group, tp=tp)
    data_group = r.data if capacity is None and tp.rows_split and r.dp > 1 else None
    return moe_apply(p, cfg, h, capacity, model_group=model_group, data_group=data_group,
                     tp=tp, _routing=_routing)
