"""The mesh as one layer of the model sees it: ``TP``, the context that the
one-device model's functions take (``tp=None`` there, which is ``ONE``:
every collective an identity), so one body of code runs a layer on one
device and on a rank of a {data, model} ``DeviceMesh`` (dist/parallel.py
holds the weights and builds the context).

A layer reads its weights from ``p``, a module of the one-device model or
dist/parallel.py's view of this rank's shards (FSDP-gathered over 'data'
where the table shards them there), and asks the context:

  * ``sharded(p)``: whether the table splits ``p``'s weights over 'model'
    (every parameter of a layer is split alike, or none);
  * ``enter``/``leave``: into a sharded layer (copy-to, or the all-gather
    of the sequence under sequence parallelism) and out of it (the all-
    reduce of a row-parallel product, or the reduce-scatter);
  * ``rep``/``cols``: a weight that the table replicates, read inside a
    sharded layer or on a slice of the sequence (through copy-to, so its
    gradient is whole), or a column-parallel layer's bias, cut to this
    rank's columns;
  * ``psum``, ``gather``, ``gather_whole``, ``halves``: a row-parallel
    product that this rank's shards go on reading (all-reduced both
    ways), an all-gather before a sharded consumer (reduce-scatter
    backward) or before a computation every rank repeats whole (slice
    backward), and the regrouping of a fused column-parallel projection
    into this rank's slices of its two halves (collectives.
    regroup_halves);
  * ``embed``/``head``: the vocab-parallel embedding and head;
  * at decode, the layer's cache specs (``at``): the positions of this
    rank's slice of a sequence-split cache and the log-sum-exp merge over
    the axes of the split, and a recurrent state gathered whole over
    'model' and cut back (``state_whole``/``state_part``).
"""
from __future__ import annotations

import copy
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import (all_gather, all_reduce_, all_reduce_sum, copy_to,
                                          gather_from, gather_whole, reduce_from,
                                          regroup_halves, scatter_to)


@dataclasses.dataclass
class Ranks:
    """A {data, model} ``DeviceMesh`` from this rank: its two groups, their
    sizes and this rank's coordinate in each."""
    data: object
    model: object
    dp: int
    tp: int
    dr: int
    mr: int

    @classmethod
    def of(cls, mesh) -> Ranks:
        names = tuple(mesh.mesh_dim_names or ())
        if names != ("data", "model"):
            raise ValueError(f"the sharded runtime takes a ('data', 'model') mesh, not {names}")
        sizes = shd._mesh_sizes(mesh)
        return cls(mesh.get_group("data"), mesh.get_group("model"),
                   sizes["data"], sizes["model"], mesh.get_local_rank("data"),
                   mesh.get_local_rank("model"))


def _axis_dim(spec, axis: str):
    """The tensor dim whose entry names ``axis``, or None."""
    return next((d for d, e in enumerate(spec) if axis in shd._axes_of(e)), None)


class TP:
    """A layer's view of the mesh (``ranks`` None: one device).  ``sp``:
    Megatron sequence parallelism on the residual stream; ``rows_split``:
    the batch rows are split over 'data'; ``cache_spec``: the specs of the
    decode cache the layer reads (``at``)."""

    def __init__(self, ranks: Ranks | None = None, mesh=None, *, sp: bool = False,
                 rows_split: bool = False, cache_spec=None):
        self.r, self.mesh, self.sp, self.rows_split = ranks, mesh, sp, rows_split
        self.cache_spec = cache_spec

    def at(self, cache_spec) -> TP:
        """This context for a layer whose decode cache has ``cache_spec``."""
        out = copy.copy(self)
        out.cache_spec = cache_spec
        return out

    @property
    def model(self):
        return self.r.model

    # -- the weights ----------------------------------------------------------
    def sharded(self, p) -> bool:
        return self.r is not None and p._sharded

    def split(self, p, name: str) -> bool:
        """Whether ``p``'s parameter ``name`` is split over 'model'."""
        return self.r is not None and p._split(name)

    def rep(self, w, sharded: bool):
        """A weight the table replicates over 'model', read in a sharded
        layer or on a slice of the sequence: through copy-to."""
        if w is None or not (sharded or self.sp):
            return w
        return copy_to(w, self.r.model)

    def cols(self, b, width: int, sharded: bool):
        """A column-parallel layer's (replicated) bias: this rank's
        ``width`` columns."""
        b = self.rep(b, sharded)
        if b is None or b.shape[-1] == width:
            return b
        return b[..., self.r.mr * width:(self.r.mr + 1) * width]

    def lo(self, n_local: int, sharded: bool) -> int:
        """The first index of this rank's ``n_local`` of a split dim."""
        return self.r.mr * n_local if sharded else 0

    # -- entering and leaving a sharded layer ---------------------------------
    def enter(self, h, sharded: bool):
        if self.sp:
            return gather_from(h, 1, self.r.model)
        return copy_to(h, self.r.model) if sharded else h

    def leave(self, y, sharded: bool):
        if self.sp:
            return scatter_to(y, 1, self.r.model)
        return reduce_from(y, self.r.model) if sharded else y

    def psum(self, y, sharded: bool):
        """A row-parallel product that this rank's shards read on: summed
        over 'model', the gradient summed back."""
        return all_reduce_sum(y, self.r.model) if sharded else y

    def gather(self, y, dim: int, sharded: bool):
        return gather_from(y, dim, self.r.model) if sharded else y

    def gather_whole(self, y, dim: int, sharded: bool):
        return gather_whole(y, dim, self.r.model) if sharded else y

    def halves(self, y, sharded: bool):
        """A fused column-parallel projection's output -> this rank's
        slices of its two halves (the one-device ``chunk(2, -1)``)."""
        if sharded:
            y = regroup_halves(y, self.r.model)
        return y.chunk(2, dim=-1)

    def seq_slice(self, y, dim: int):
        """This rank's slice of the sequence under sequence parallelism."""
        if not self.sp:
            return y
        n = y.shape[dim] // self.r.tp
        return y.narrow(dim, self.r.mr * n, n)

    # -- the vocab-parallel embedding and head --------------------------------
    def embed(self, params, tokens, dtype, prefix=None):
        """tokens [b, s] -> their embedding rows in ``dtype`` (after
        ``prefix`` [b, n, D], the vision stub's image embeddings, when
        given), whole over 'model' (this rank's slice of the whole
        sequence under sequence parallelism).  A vocab-split table is a
        masked lookup summed over 'model'; the prefix joins on model rank
        0 before the sum."""
        table = params.embed
        if not self.split(params, "embed"):
            x = table[tokens].to(dtype)
            if prefix is not None:
                x = torch.cat([prefix.to(dtype), x], dim=1)
            return self.seq_slice(x, 1)
        n = table.shape[0]
        idx = tokens - self.r.mr * n
        ok = (idx >= 0) & (idx < n)
        e = torch.where(ok[..., None], table[idx.clamp(0, n - 1)], 0.0)
        if prefix is not None:
            first = prefix.to(e.dtype) if self.r.mr == 0 else torch.zeros_like(prefix, dtype=e.dtype)
            e = torch.cat([first, e], dim=1)
        return self.leave(e, True).to(dtype)

    def head(self, params, x):
        """Hidden states -> the logits (this rank's vocab slice of them
        where the head is split): the tied embedding's transpose, or
        ``lm_head``."""
        tied = getattr(params, "lm_head", None) is None
        x = self.enter(x, self.split(params, "embed" if tied else "lm_head.w"))
        if tied:
            return x @ params.embed.T.to(x.dtype)
        y = x @ params.lm_head.w.to(x.dtype)
        b = self.cols(params.lm_head.b, y.shape[-1], self.split(params, "lm_head.w"))
        return y if b is None else y + b.to(y.dtype)

    # -- decode caches --------------------------------------------------------
    def _cache_entry(self, key: str, dim: int) -> tuple:
        if self.cache_spec is None:
            return ()
        spec = self.cache_spec[key]
        spec = spec[0] if isinstance(spec, tuple) and not isinstance(spec, shd.Spec) else spec
        return shd._axes_of(spec[dim]) if dim < len(spec) else ()

    def cache_offset(self, key: str, dim: int, S: int) -> int:
        """The first position of this rank's ``S`` slots of the sequence dim
        ``dim`` of cache leaf ``key`` (0 where it is whole)."""
        axes = self._cache_entry(key, dim)
        return shd.shard_index(axes, self.mesh)[0] * S if axes else 0

    def cache_positions(self, key: str, dim: int, S: int, device):
        """The positions of this rank's ``S`` slots of the sequence dim
        ``dim`` of cache leaf ``key`` (``arange(S)`` where it is whole),
        and the log-sum-exp merge over the axes that split it (None)."""
        axes = self._cache_entry(key, dim)
        lo = self.cache_offset(key, dim, S)
        idx = torch.arange(lo, lo + S, device=device) if lo else torch.arange(S, device=device)
        if not axes:
            return idx, None
        groups = [self.mesh.get_group(a) for a in axes]
        ops = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}

        def merge(t, op):
            for g in groups:
                all_reduce_(t, g, ops[op])
        return idx, merge

    def state_whole(self, cache: dict) -> dict:
        """A recurrent layer's cache, each leaf gathered whole along the dim
        its spec splits over 'model'."""
        if self.cache_spec is None:
            return cache
        out = {}
        for k, t in cache.items():
            d = _axis_dim(self.cache_spec[k], "model")
            out[k] = t if d is None else all_gather(t, d, self.r.model)
        return out

    def state_part(self, cache: dict) -> dict:
        """The inverse of ``state_whole``: each leaf cut to this rank's
        slice."""
        if self.cache_spec is None:
            return cache
        out = {}
        for k, t in cache.items():
            d = _axis_dim(self.cache_spec[k], "model")
            if d is None:
                out[k] = t
            else:
                n = t.shape[d] // self.r.tp
                out[k] = t.narrow(d, self.r.mr * n, n).contiguous()
        return out


ONE = TP()
