"""Collectives over ``torch.distributed`` groups, as plain functions and
as autograd functions for the sharded runtime (dist/parallel.py) and the
expert-parallel MoE (models/moe.py).  Each autograd function's backward is
the transpose of its forward: ``reduce_from`` (all-reduce, then identity;
Megatron's g), ``copy_to`` (identity, then all-reduce; Megatron's f),
``gather_from`` / ``scatter_to`` (all-gather along a dim and reduce-scatter
along it, each the other's transpose), ``all_reduce_sum`` (all-reduce both
ways: a sum over ranks that every rank then uses), and ``all_to_all``
(equal chunks of dim 0 exchanged: its own transpose).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` all-reduced over ``group`` in place, whatever its strides (NCCL
    takes contiguous tensors only; a strided one goes through a contiguous
    copy and keeps its own layout)."""
    if t.is_contiguous():
        dist.all_reduce(t, op=op, group=group)
        return t
    buf = t.contiguous()
    dist.all_reduce(buf, op=op, group=group)
    return t.copy_(buf)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new (contiguous) tensor: ``x`` all-reduced over ``group``."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y


def gather_stacked(x: torch.Tensor, group) -> torch.Tensor:
    """[n, *x.shape]: ``x`` of each of the group's n ranks, in rank order."""
    n = dist.get_world_size(group)
    out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=group)
    return out.view((n,) + tuple(x.shape))


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` of every rank of ``group`` concatenated along ``dim``, in rank
    order."""
    n = dist.get_world_size(group)
    out = gather_stacked(x, group)
    if dim == 0:
        return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat(out.unbind(0), dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ``group`` of ``x``, this rank's chunk along ``dim``."""
    n = dist.get_world_size(group)
    chunks = torch.stack(x.chunk(n, dim))
    out = torch.empty((chunks[0].numel(),), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, chunks.reshape(-1), group=group)
    return out.view(chunks.shape[1:])


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward, reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _AllReduceSum(torch.autograd.Function):
    """All-reduce forward and backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    """Chunk ``j`` of dim 0 to rank ``j``; the chunks received, in rank
    order, along dim 0."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def all_reduce_sum(x, group):
    return _AllReduceSum.apply(x, group)


def all_to_all(x, group):
    return _AllToAll.apply(x, group)


def reduce_from(x, group):
    return _Reduce.apply(x, group)


def copy_to(x, group):
    return _Copy.apply(x, group)


def gather_from(x, dim: int, group):
    return _Gather.apply(x, dim, group)


def scatter_to(x, dim: int, group):
    return _Scatter.apply(x, dim, group)


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp(x, -1)`` over a last dim split across ``group``:
    torch's own sequence of operations (the max, the inf guard, the sum of
    ``exp(x - max)``, its log plus the max), with the max and the sum
    all-reduced, and torch's own backward, ``g * exp(x - lse)``."""

    @staticmethod
    def forward(ctx, x, group):
        maxes = all_reduce_(torch.amax(x, -1, keepdim=True), group, dist.ReduceOp.MAX)
        m = maxes.squeeze(-1)
        m.masked_fill_(m.abs() == float("inf"), 0)
        s = all_reduce_(torch.sum((x - maxes).exp_(), -1), group)
        out = s.log_().add_(m)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g.unsqueeze(-1) * (x - out.unsqueeze(-1)).exp(), None
