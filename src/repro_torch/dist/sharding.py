"""The sharding rule table (port of ``repro/dist/sharding.py``): pure
functions from (config, tree, mesh) to a spec per leaf, and the small
runtime layer that the sharded model code reads.

A spec is a tuple with one entry per dimension: None, an axis name, or a
tuple of axis names (outermost first).  It equals ``tuple(P)`` of the
reference's ``PartitionSpec`` for the same leaf.  The rules are the
reference's (DESIGN.md §7):

  * 'model' is the tensor-parallel axis.  Attention shards the *head* axis
    (weights are head-shaped, see models/attention.py), FFNs shard the
    hidden dim, vocab-sized matrices shard the vocab dim, SSM/xLSTM blocks
    shard d_inner / d_x.  K/V projections are replicated.
  * 'data' (times 'pod' when present) is the data-parallel axis; parameters
    of at least ``FSDP_MIN_ELEMS`` elements also shard their largest free
    dim over 'data' (FSDP), and ZeRO-1 extends every optimizer moment with
    'data' on its first free dim (``opt_state_pspec``).
  * Every rule is guarded by exact divisibility: an axis that does not
    divide is dropped, and the entry degrades to replication.
  * Rules read only the mesh's axis names and sizes: a ``DeviceMesh``, or
    any object with ``.shape`` (a {name: size} mapping, or sizes beside
    ``.axis_names``), so they run without devices.

Parameter keys are the reference's tree paths (``blocks/0/attn/wq``): the
port's model is carried into that tree by ``models/convert.py``
(``reference_layout``), its stacked leaves ``[n_periods, ...]``.
``layer_specs`` gives each named parameter of the port's model its entry
with the stacked axis taken off, which is what a rank's per-layer tensor
holds.

The runtime layer: ``placements`` turns a spec into DTensor placements
(``Shard(d)`` / ``Replicate()``) on a ``DeviceMesh``; ``local_slices`` /
``shard_tensor`` / ``gather_tensor`` and the tree forms ``shard_tree`` /
``gather_tree`` move between a full tensor and a rank's local shard, and
``gather_to_host`` brings one leaf whole to one rank's host memory (a
checkpoint's write); ``use_mesh`` / ``_ambient_mesh`` hold the ambient mesh, and
``set_sequence_parallel`` the trace-time switch of Megatron sequence
parallelism, which the sharded train step sets.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from collections.abc import Mapping
from typing import Any

import torch

# Parameters with at least this many elements get their largest free dim
# sharded over 'data' on top of tensor parallelism (FSDP).
FSDP_MIN_ELEMS = 1 << 24

# Axes that compose the data-parallel dimension, outermost first ('pod' is
# the DCN axis of the multipod mesh, see launch/mesh.py).
DP_AXES = ("pod", "data")


# ---------------------------------------------------------------------------
# ambient mesh and the sequence-parallel switch
# ---------------------------------------------------------------------------
_MESH_STACK: list[Any] = []
_SEQ_PARALLEL = False


def _ambient_mesh():
    """The innermost mesh set through ``use_mesh`` (None outside any)."""
    return _MESH_STACK[-1] if _MESH_STACK else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` as the ambient mesh for the block's duration."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def set_sequence_parallel(flag: bool) -> None:
    """Megatron sequence parallelism on the residual stream: when on, the
    sharded blocks keep the residual stream split along the sequence over
    'model' between blocks (a reduce-scatter and an all-gather in place of
    each all-reduce).  Set by the sharded train step from its settings."""
    global _SEQ_PARALLEL
    _SEQ_PARALLEL = bool(flag)


def sequence_parallel() -> bool:
    return _SEQ_PARALLEL


def constrain(x, *parts):
    """The reference pins an activation's layout for GSPMD here.  The port
    has no partitioner: each rank computes on its local shard eagerly, so
    ``constrain`` returns ``x`` unchanged, and where a layout must change
    (sequence parallelism's gather and scatter, the vocab gather of the
    logits) the sharded runtime (dist/parallel.py) calls that collective
    itself."""
    del parts
    return x


# ---------------------------------------------------------------------------
# mesh introspection (duck-typed: DeviceMesh, the production mesh, fakes)
# ---------------------------------------------------------------------------
def _mesh_sizes(mesh) -> dict[str, int]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a torch DeviceMesh
        return dict(zip(names, tuple(mesh.shape)))
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.axis_names, shape))


def _axes_of(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def _used_axes(entries) -> set:
    return {a for e in entries for a in _axes_of(e)}


class Spec(tuple):
    """A leaf's spec: a tuple of per-dimension entries, told apart from the
    tuples of a tree (a KV cache's (k, v)) by its type."""

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def batch_dp(mesh):
    """The composite data-parallel entry of this mesh: 'data', or
    ('pod', 'data') on the multipod mesh."""
    sizes = _mesh_sizes(mesh)
    dp = tuple(a for a in DP_AXES if a in sizes)
    if not dp:
        return None
    return dp if len(dp) > 1 else dp[0]


def _dp_entry(mesh, dim_size: int):
    """Data-parallel entry for a batch dim, or None if it does not divide."""
    sizes = _mesh_sizes(mesh)
    dp = tuple(a for a in DP_AXES if a in sizes and sizes[a] > 1)
    if not dp:
        return None
    total = math.prod(sizes[a] for a in dp)
    if dim_size % total == 0:
        return dp if len(dp) > 1 else dp[0]
    # fall back to the inner 'data' axis alone (pod stays replicated)
    if "data" in dp and dim_size % sizes["data"] == 0:
        return "data"
    return None


# ---------------------------------------------------------------------------
# trees: nested dicts, lists and tuples with shaped leaves
# ---------------------------------------------------------------------------
def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree's leaves; a path holds dict keys and
    list/tuple positions."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _map_specs(fn, specs, *others):
    """``fn`` over the spec leaves of a spec tree, with the leaves at the
    same place in ``others``."""
    if isinstance(specs, Spec):
        return fn(specs, *others)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, *(o[k] for o in others)) for k, v in specs.items()}
    return type(specs)(_map_specs(fn, v, *(o[i] for o in others))
                       for i, v in enumerate(specs))


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def reference_shapes(params, cfg) -> dict:
    """The reference's parameter tree for the port's model ``params``
    (a ``transformer.LM`` or ``encdec.EncDec``), with a meta tensor of the
    stacked leaf's shape and dtype at each leaf: nothing is allocated."""
    from repro_torch.models.convert import reference_layout, to_reference_tree
    metas = {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
             for n, p in params.named_parameters()}
    return to_reference_tree(metas, reference_layout(params, cfg))


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------
# Dense-wrapped weights ({"w": ...}) keyed by their owner, mapped to the
# tensor-parallel dim (negative index into the leaf shape).  Column-parallel
# projections shard their output dim (-1); row-parallel ones their input
# dim (-2) so the following contraction reduces with one all-reduce.
_DENSE_COL = ("wi/w", "wg/w", "up/w", "in_proj/w", "dt_proj/w", "wv/w",
              "w_o/w", "wq/w", "wk/w", "slstm/w")
_DENSE_ROW = ("wo/w", "down/w", "out_proj/w", "x_proj/w")


def _tp_rule(key: str, ndim: int) -> int | None:
    """Tensor-parallel dim (negative index) for a param path, or None."""
    last = key.rsplit("/", 1)[-1]
    # replicated: norms, biases, routers, tiny gate tables, position tables
    if "norm" in key or last in ("scale", "bias", "b", "b_if", "router",
                                 "pos_embed", "dec_pos", "r"):
        return None
    if key.endswith("lm_head/w"):
        return -1                       # vocab (column) parallel
    # attention: head-sharded q/out, replicated k/v
    if "attn/" in key:                  # matches attn/ and xattn/
        if last in ("wq", "bq"):
            return -2                   # [.., D, H, dh] / [.., H, dh]
        if last == "wo":
            return -3                   # [.., H, dh, D]
        return None                     # wk, wv, bk, bv
    for suffix in _DENSE_COL:
        if key.endswith(suffix):
            return -1
    for suffix in _DENSE_ROW:
        if key.endswith(suffix):
            return -2
    # bare (stacked) weights: MoE experts, SSM/xLSTM tables
    if last in ("wi", "wg"):
        return -1                       # moe [.., E, D, F]: hidden dim
    if last == "wo":
        return -2                       # moe [.., E, F, D]: hidden dim
    if last in ("conv_w", "conv_b", "D"):
        return -1                       # [.., k, d_inner] / [.., d_inner]
    if last in ("A_log", "w_if"):
        return -2                       # [.., d_inner, n] / [.., dx, 2H]
    return None


def leaf_pspec(cfg, key: str, shape, mesh) -> tuple:
    """The spec of one parameter leaf (the reference's key path ``key``,
    its stacked shape)."""
    sizes = _mesh_sizes(mesh)
    model = sizes.get("model", 1)
    data = sizes.get("data", 1)
    ep = bool(getattr(cfg, "moe_ep", False))
    n_experts = getattr(cfg, "padded_experts", 0)
    shape = tuple(shape)
    ndim = len(shape)
    entries: list = [None] * ndim
    last = key.rsplit("/", 1)[-1]
    no_fsdp = False
    if last == "embed":
        # vocab-parallel, never FSDP'd: the tied head matmul wants the
        # d_model dim intact
        if model > 1 and shape[0] % model == 0:
            entries[0] = "model"
        no_fsdp = True
    else:
        tp = _tp_rule(key, ndim)
        if tp is not None and model > 1:
            dim = ndim + tp
            if 0 <= dim < ndim and shape[dim] % model == 0:
                entries[dim] = "model"
        if ep and last in ("wi", "wg", "wo") and "moe/" in key \
                and ndim >= 3 and data > 1 and n_experts \
                and shape[ndim - 3] % data == 0:
            # expert parallelism: experts ride the data axis (all-to-all
            # dispatch); that axis is then spoken for, no FSDP on top
            entries[ndim - 3] = "data"
            no_fsdp = True
    if not no_fsdp and data > 1 and "data" not in _used_axes(entries) \
            and math.prod(shape) >= FSDP_MIN_ELEMS:
        free = [i for i in range(ndim) if entries[i] is None and shape[i] % data == 0]
        if free:
            entries[max(free, key=lambda i: shape[i])] = "data"
    return Spec(entries)


def param_pspecs(cfg, params, mesh):
    """The spec tree of a parameter tree of this arch on this mesh, in the
    reference's tree.  ``params`` is the port's model (its leaves are
    stacked by period first, ``reference_shapes``) or a tree of shaped
    leaves already in the reference's layout."""
    if isinstance(params, torch.nn.Module):
        params = reference_shapes(params, cfg)
    return _map_with_path(
        lambda path, leaf: leaf_pspec(cfg, _path_str(path), leaf.shape, mesh), params)


def opt_state_pspec(param_spec: tuple, shape, mesh) -> tuple:
    """ZeRO-1: extend a param's spec with 'data' on its first free,
    evenly-divisible dim, for the optimizer moment of that param."""
    sizes = _mesh_sizes(mesh)
    data = sizes.get("data", 1)
    entries = [param_spec[i] if i < len(param_spec) else None for i in range(len(shape))]
    if data > 1 and "data" not in _used_axes(entries):
        for i, dim in enumerate(shape):
            if entries[i] is None and dim % data == 0:
                entries[i] = "data"
                break
    return Spec(entries)


def layer_specs(cfg, params, mesh, *, opt: bool = False) -> dict:
    """{parameter name of the port's model: its spec}, the stacked leaf's
    spec with the period axis taken off for a per-layer parameter.  With
    ``opt``, the ZeRO-1 spec of its optimizer moments instead, whose data
    entry may fall on the period axis: such a name maps to (spec, owner)
    where ``owner`` is the (axes, index) that holds its layer, else
    (spec, None)."""
    from repro_torch.models.convert import reference_layout
    layout = reference_layout(params, cfg)
    out = {}
    for name, p in params.named_parameters():
        path, idx = layout[name]
        stacked = tuple(p.shape) if idx is None else (_n_stacked(cfg, path),) + tuple(p.shape)
        spec = leaf_pspec(cfg, _path_str(path), stacked, mesh)
        if opt:
            spec = opt_state_pspec(spec, stacked, mesh)
        if idx is None:
            out[name] = (spec, None) if opt else spec
            continue
        owner = None
        if spec[0] is not None:
            if not opt:
                raise NotImplementedError(
                    f"{name}: the table shards the period axis of "
                    f"{_path_str(path)} ({spec}); a per-layer parameter cannot hold that")
            n = stacked[0] // math.prod(_mesh_sizes(mesh)[a] for a in _axes_of(spec[0]))
            owner = (_axes_of(spec[0]), idx // n)
        out[name] = (Spec(spec[1:]), owner) if opt else Spec(spec[1:])
    return out


def _n_stacked(cfg, path) -> int:
    if path[0] == "enc_blocks":
        return cfg.encoder_layers
    if path[0] == "dec_blocks":
        return cfg.n_layers
    return cfg.n_periods


# ---------------------------------------------------------------------------
# input / cache / output rules
# ---------------------------------------------------------------------------
def input_pspecs(cfg, kind: str, inputs, mesh):
    """Batch-dim data parallelism for every model input leaf."""
    del cfg, kind

    def rule(_, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return Spec()
        return Spec([_dp_entry(mesh, shape[0])] + [None] * (len(shape) - 1))

    return _map_with_path(rule, inputs)


_KV_KEYS = ("kv", "self_k", "self_v", "cross_k", "cross_v")


def cache_pspecs(cfg, cache, mesh, *, seq_shard: bool = False):
    """Decode-cache specs, on the reference's stacked cache tree.  KV
    caches [layers, b, KV, S, dh] shard batch over the dp axes and, for
    long contexts (``seq_shard``) or whenever 'model' divides, the sequence
    axis; kv heads stay replicated.  Recurrent-state caches shard batch
    plus their largest inner dim over 'model'."""
    del cfg
    sizes = _mesh_sizes(mesh)
    model = sizes.get("model", 1)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        ndim = len(shape)
        keys = {k for k in path if isinstance(k, str)}
        entries: list = [None] * ndim
        if ndim >= 2:
            entries[1] = _dp_entry(mesh, shape[1])
        if keys & set(_KV_KEYS) and ndim == 5:
            seq_axes: list[str] = []
            prod = 1
            candidates = ["model"]
            if seq_shard:
                # long-context: fold free dp axes into the sequence split too
                candidates += [a for a in DP_AXES
                               if a in sizes and a not in _used_axes(entries)]
            for a in candidates:
                if sizes.get(a, 1) > 1 and shape[3] % (prod * sizes[a]) == 0:
                    seq_axes.append(a)
                    prod *= sizes[a]
            if seq_axes:
                entries[3] = tuple(seq_axes) if len(seq_axes) > 1 else seq_axes[0]
        elif ndim >= 3 and model > 1:
            # recurrent state: TP its largest inner dim (d_inner / dx / dh)
            free = [i for i in range(2, ndim) if shape[i] % model == 0]
            if free:
                entries[max(free, key=lambda i: shape[i])] = "model"
        return Spec(entries)

    return _map_with_path(rule, cache)


def layer_cache_specs(cfg, cache: list, mesh, *, seq_shard: bool = False) -> list:
    """The port's per-layer decode cache (``transformer.init_cache``) ->
    the same structure of specs: each layer's entries are its pattern
    position's stacked specs (``cache_pspecs``) with the period axis taken
    off."""
    n = len(cfg.block_pattern)
    stack = lambda t: torch.empty((cfg.n_periods,) + tuple(t.shape), device="meta")
    stacked = [_map_with_path(lambda _, t: stack(t), cache[j]) for j in range(n)]
    specs = cache_pspecs(cfg, stacked, mesh, seq_shard=seq_shard)
    return [_map_specs(lambda s: Spec(s[1:]), specs[layer % n]) for layer in range(len(cache))]


def logits_pspec(mesh) -> tuple:
    """[batch, seq, vocab] logits: dp on batch, vocab-parallel on 'model'."""
    return (batch_dp(mesh), None, "model")


def query_pspecs(mesh, batch_size: int) -> tuple:
    """SM-tree query-cohort sharding: [b, dim] batches split over the dp
    axes (divisibility-guarded), tree pages replicated.  The cohort descent
    is batched over b in every op, so each rank descends its own rows with
    no collective; the mesh store gathers the results."""
    return (_dp_entry(mesh, batch_size), None)


# ---------------------------------------------------------------------------
# placement on a DeviceMesh, local shards
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh: where ``restore_checkpoint(shardings=)``
    places a leaf (this rank's local shard, on the mesh's device)."""
    mesh: Any
    spec: tuple


def to_named(specs, mesh):
    """A spec tree as ``NamedSharding``s on ``mesh``."""
    return _map_specs(lambda s: NamedSharding(mesh, s), specs)


def placements(spec: tuple, mesh) -> tuple:
    """A spec as DTensor placements, one per mesh dim: ``Shard(d)`` where
    tensor dim ``d`` names that axis, else ``Replicate()``.  Two axes on one
    tensor dim (('pod', 'data')) shard it in mesh-dim order, outermost
    first, as the table means."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in _mesh_sizes(mesh):
        dims = [d for d, e in enumerate(spec) if axis in _axes_of(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def mesh_coords(mesh) -> dict[str, int]:
    """This rank's coordinate along each axis of a ``DeviceMesh``."""
    return {a: mesh.get_local_rank(a) for a in _mesh_sizes(mesh)}


def shard_index(entry, mesh, coords: Mapping | None = None) -> tuple[int, int]:
    """(which of the pieces, how many pieces) of a dim whose spec entry is
    ``entry``, for the rank at ``coords`` (default: this rank on ``mesh``):
    the linear index over the entry's axes, outermost first."""
    sizes = _mesh_sizes(mesh)
    coords = mesh_coords(mesh) if coords is None else coords
    idx, count = 0, 1
    for a in _axes_of(entry):
        idx, count = idx * sizes[a] + coords[a], count * sizes[a]
    return idx, count


def local_slices(spec: tuple, shape, mesh, coords: Mapping | None = None) -> tuple:
    """The slice of each dim that the rank at ``coords`` (default: this
    rank on ``mesh``) holds of a leaf of ``shape`` under ``spec``."""
    coords = mesh_coords(mesh) if coords is None else coords
    out = []
    for d, n in enumerate(shape):
        idx, count = shard_index(spec[d] if d < len(spec) else None, mesh, coords)
        if n % count:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split {count} ways ({spec})")
        size = n // count
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def shard_tensor(full: torch.Tensor, spec: tuple, mesh, *, device=None,
                 coords: Mapping | None = None) -> torch.Tensor:
    """This rank's local shard of ``full`` (a contiguous copy on
    ``device``, default ``full``'s)."""
    t = full[local_slices(spec, full.shape, mesh, coords)]
    return t.to(device if device is not None else full.device, copy=True).contiguous()


def gather_tensor(local: torch.Tensor, spec: tuple, shape, mesh, group=None) -> torch.Tensor:
    """The full tensor of ``shape`` on every rank, from every rank's local
    shard: one all-gather over ``group`` (default: the world, whose ranks
    must be the mesh's), each shard written at its slice (replicas write
    equal values)."""
    import torch.distributed as dist

    from repro_torch.dist.collectives import gather_stacked
    parts = gather_stacked(local, group)
    full = torch.empty(tuple(shape), dtype=local.dtype, device=local.device)
    for i in range(dist.get_world_size(group)):
        c = rank_coords(mesh, dist.get_global_rank(group, i) if group is not None else i)
        full[local_slices(spec, shape, mesh, c)] = parts[i]
    return full


def rank_coords(mesh, rank: int) -> dict[str, int]:
    """The coordinates of global rank ``rank`` on a ``DeviceMesh``."""
    where = (mesh.mesh == rank).nonzero()[0].tolist()
    return dict(zip(_mesh_sizes(mesh), where))


def gather_to_host(local: torch.Tensor, spec: tuple, shape, mesh, dst: int = 0,
                   sources=None) -> torch.Tensor | None:
    """The full tensor of ``shape`` in host memory on global rank ``dst``,
    None on every other rank: one ``dist.gather`` of every rank's local
    shard (the world's ranks must be the mesh's), each written at its
    slice.  ``sources(coords)`` picks the ranks whose shards hold the
    values (default: all; replicas write equal values); the others send
    a shard of the same shape that is not read."""
    import torch.distributed as dist
    x = local.contiguous()
    parts = ([torch.empty_like(x) for _ in range(dist.get_world_size())]
             if dist.get_rank() == dst else None)
    dist.gather(x, parts, dst=dst)
    if parts is None:
        return None
    full = torch.empty(tuple(shape), dtype=local.dtype)
    for r, part in enumerate(parts):
        c = rank_coords(mesh, r)
        if sources is None or sources(c):
            full[local_slices(spec, shape, mesh, c)] = part.cpu()
    return full


def shard_tree(tree, specs, mesh, *, device=None):
    """Every leaf of a full tensor tree as this rank's local shard."""
    return _map_specs(lambda s, t: shard_tensor(t, s, mesh, device=device), specs, tree)


def gather_tree(local_tree, specs, shapes, mesh, group=None):
    """The inverse of ``shard_tree``: the full tree from every rank's
    local shards (``shapes``: a tree of the full leaves' shapes, or of
    tensors that have them)."""
    return _map_specs(lambda s, t, full: gather_tensor(
        t, s, tuple(getattr(full, "shape", full)), mesh, group), specs, local_tree, shapes)
