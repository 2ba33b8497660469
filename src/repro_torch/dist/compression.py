"""int8 gradient compression for the data-parallel all-reduce (port of
``repro/dist/compression.py``).

Wire scheme (per leaf): one float32 scale, ``max(amax, tiny) / 127`` with
``amax`` the leaf's largest |g| (the group's largest, all-reduced with MAX,
in ``compressed_psum_mean``), the gradient quantised to int8 by rounding
half to even (``torch.round``, as ``jnp.round``), summed as int32 and
dequantised once.  The error-feedback residual ``g - deq(q(g))`` comes back
beside it, for the caller to fold into the next step's gradient (EF-SGD).

  * ``compressed_mean_hook`` quantises and dequantises in place of the
    all-reduce that autograd's gradients already stand for: the numerics
    the wire would impose, bitwise the reference's for the same gradient,
    on either device;
  * ``compressed_psum_mean`` is the collective over a ``torch.distributed``
    group.

A tree is nested dicts, lists and tuples of tensors, as the reference's
pytrees are.  ``compressed_mean_hook(groups=)`` also takes a flat
{name: tensor} dict whose names are grouped to share one scale: the port's
train step passes the per-layer slices of each stacked leaf of the
reference's tree as one group, so its scales are the reference's.
"""
from __future__ import annotations

import torch

_QMAX = 127.0


def _map(fn, *trees):
    """``fn`` over the leaves of the first tree, each with whatever stands
    at the same place in the others (a leaf, or a pair that ``fn`` made)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_map(fn, *xs) for xs in zip(*trees, strict=True))
    return fn(*trees)


def _split(tree, pairs):
    """``pairs`` (``tree`` with an (a, b) pair at each leaf) as two trees."""
    return _map(lambda _, p: p[0], tree, pairs), _map(lambda _, p: p[1], tree, pairs)


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    # divided by a tensor: on the card a Python divisor becomes a product
    # with its reciprocal, which is not the reference's quotient
    qmax = torch.full((), _QMAX, dtype=torch.float32, device=amax.device)
    return amax.clamp_min(torch.finfo(torch.float32).tiny) / qmax


def _quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -_QMAX, _QMAX).to(torch.int8)


def _hook_group(gs: list, es: list | None, group=None) -> tuple[list, list]:
    """Quantise and dequantise the tensors of one group with one scale,
    the residuals ``es`` (or None) folded in first; with a process
    ``group``, the scale's amax is the largest over its ranks.  ->
    (outputs, residuals), each in its gradient's dtype."""
    gf = [g.float() for g in gs]
    if es is not None:
        gf = [t + e.float() for t, e in zip(gf, es, strict=True)]
    amax = gf[0].abs().max()
    for t in gf[1:]:
        amax = torch.maximum(amax, t.abs().max())
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = _scale_of(amax)
    outs, errs = [], []
    for g, t in zip(gs, gf):
        deq = _quantize(t, scale).float() * scale
        outs.append(deq.to(g.dtype))
        errs.append((t - deq).to(g.dtype))
    return outs, errs


def compressed_mean_hook(grads, mode: str = "int8", ef=None, *, groups=None,
                         group=None):
    """Quantise-dequantise every floating gradient (int8, one float32 scale
    a leaf); leaf dtypes are kept.  A passthrough for ``mode`` in (None,
    "none", False).

    With ``ef`` (residuals shaped like ``grads``) the residual is folded in
    before quantising, q(g + e), and the call returns ``(grads_out,
    ef_next)`` with ``ef_next = (g + e) - deq(...)``; without it, just
    ``grads_out``.  ``groups`` (lists of keys of a flat dict ``grads``)
    makes each group's tensors share one scale.  ``group`` (a process
    group, with ``groups``): the gradients are this rank's shards of
    gradients already reduced over the data ranks, and each scale's amax
    is all-reduced with MAX over ``group``, so every shard of a leaf is
    quantised with the whole leaf's scale, the reference's numerics."""
    if mode in (None, "none", False):
        return grads if ef is None else (grads, ef)
    if groups is None:
        def leaf(g, e=None):
            if not g.is_floating_point():
                return g, e     # an EF placeholder passes through untouched
            (o,), (r,) = _hook_group([g], None if e is None else [e])
            return o, r
        out, ef_next = _split(grads, _map(leaf, grads) if ef is None
                              else _map(leaf, grads, ef))
        return out if ef is None else (out, ef_next)
    out, ef_next = {}, {}
    for keys in groups:
        outs, errs = _hook_group([grads[k] for k in keys],
                                 None if ef is None else [ef[k] for k in keys], group)
        out.update(zip(keys, outs))
        ef_next.update(zip(keys, errs))
    return out if ef is None else (out, ef_next)


def init_ef_state(params):
    """Zero residuals shaped like the floating leaves of ``params`` (a tree
    or a {name: tensor} dict); a non-floating leaf gets a float32 zero
    scalar, so the structures match."""
    return _map(lambda p: (torch.zeros_like(p) if p.is_floating_point()
                           else torch.zeros((), dtype=torch.float32, device=p.device)),
                params)


def compressed_psum_mean(tree, group=None, ef=None):
    """Compressed mean all-reduce over the ``torch.distributed`` group
    ``group`` (None: the default group).  Returns (mean tree, residual
    tree): each leaf's dequantised mean over the ranks, and this rank's
    residual ``g - deq(q(g))``, ``ef`` folded in first when given (the
    next EF state).  The scale is shared through a MAX all-reduce of each
    leaf's amax; the int8 values are summed as int32."""
    import torch.distributed as dist

    world = float(dist.get_world_size(group))

    def leaf(g, e=None):
        gf = g.float() if e is None else g.float() + e.float()
        amax = gf.abs().max()
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = _scale_of(amax)
        q = _quantize(gf, scale)
        deq = q.float() * scale
        total = q.to(torch.int32, memory_format=torch.contiguous_format)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        n = torch.full((), world, dtype=torch.float32, device=gf.device)
        mean = (total.float() * scale / n).to(g.dtype)
        return mean, (gf - deq).to(g.dtype)

    return _split(tree, _map(leaf, tree) if ef is None else _map(leaf, tree, ef))
