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


class _GatherSlice(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward, this rank's chunk of the
    gradient (Megatron's gather before a computation that every rank of
    the group repeats whole, whose gradients are then equal on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // dist.get_world_size(ctx.group)
        return g.narrow(ctx.dim, dist.get_rank(ctx.group) * n, n), None, None


def gather_whole(x, dim: int, group):
    return _GatherSlice.apply(x, dim, group)


def _halves_plan(n: int, r: int, e: int):
    """The exchange of ``regroup_halves`` at rank ``r`` of ``n``: the order
    in which to send this rank's two half-blocks (0 and 1) and the rows
    sent to and received from each rank.  Half-block u of the fused
    projection's 2n half-blocks goes to rank u % n; rank r holds u = 2r,
    2r + 1 and receives u = r (its slice of the first half) and n + r (of
    the second), the first from rank r // 2 and the second from rank
    (n + r) // 2, in that (rank) order."""
    dest = ((2 * r) % n, (2 * r + 1) % n)
    order = (0, 1) if dest[0] <= dest[1] else (1, 0)
    send = [e * sum(d == q for d in dest) for q in range(n)]
    recv = [e * sum(u // 2 == s for u in (r, n + r)) for s in range(n)]
    return order, send, recv


def _exchange(t, send, recv, group):
    out = torch.empty((sum(recv),) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_to_all_single(out, t.contiguous(), output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    return out


class _RegroupHalves(torch.autograd.Function):
    """A fused column-parallel projection regrouped (``regroup_halves``);
    backward, the same exchange reversed."""

    @staticmethod
    def forward(ctx, y, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        c = y.shape[-1]
        if c % 2:
            raise ValueError(f"a rank's block of a fused projection has an odd width {c}")
        order, send, recv = _halves_plan(n, r, c // 2)
        ctx.group, ctx.plan = group, (order, send, recv)
        t = y.movedim(-1, 0)
        if order != (0, 1):
            t = torch.cat([t[c // 2:], t[:c // 2]])
        return _exchange(t, send, recv, group).movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        order, send, recv = ctx.plan
        t = _exchange(g.movedim(-1, 0), recv, send, ctx.group)
        if order != (0, 1):
            e = t.shape[0] // 2
            t = torch.cat([t[e:], t[:e]])
        return t.movedim(0, -1), None


def regroup_halves(y, group):
    """``y`` [..., c]: this rank's block of columns of a fused projection
    [..., 2 n_cols] whose halves are two tensors (Mamba's x | z, the xLSTM
    blocks' up-projections), split column-parallel over ``group`` in
    contiguous blocks, so that at two ranks rank 0 holds the whole first
    half and rank 1 the whole second.  -> [..., c]: this rank's slice of
    the first half, then of the second, each c / 2 wide (rank r's columns
    r * c / 2 ... of each half), by one all-to-all of the local product."""
    return _RegroupHalves.apply(y, group)
