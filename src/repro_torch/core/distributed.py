"""The SM-forest: the index sharded into independent SM-trees, and the
flat-scan baseline.

Port of ``repro/core/distributed.py``.  Objects are partitioned over
``S`` shards, one SM-tree each (a *forest*).  The reference places one
shard per device of a mesh and runs each front under ``shard_map``; here
the forest is *stacked* on one device (every field gains a leading
``[S]`` axis, node tables zero-padded to the largest shard) and each front
loops over the shards, working on views of the stacked tensors:

  * ``forest_knn``: every shard runs the local kNN over its tree, then the
    per-shard candidates are merged shard-major and cut to the global
    top-k (the reference's all-gather and ``lax.top_k``);
  * ``forest_delete``, ``forest_apply_mutations``, ``forest_apply_splits``,
    ``forest_apply_merges`` and ``forest_extract_objects``: each row acts
    on its owner shard only, and the outcome is what the reference's
    ``psum`` of masked rows gives.

With a ``torch.distributed`` process group every front runs one shard per
rank instead: ``forest_knn`` and ``brute_force_knn`` all-gather the
per-shard candidates before the same merge, and the mutation fronts
all-reduce their masked rows by sum (the ``psum``).  ``place_forest`` puts
a host-side forest (a follower's shards) where the fronts serve it, and
``promote_follower`` places a replayed follower's pinned epoch there once
its digest matches the leader's.

Every selection is a stable ascending sort, so equal values come back
lowest index first, as ``jax.lax.top_k`` gives them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import smtree
from repro_torch.core.smtree import (ARRAY_FIELDS, NODE_TABLE_FIELDS,
                                     TreeArrays, bulk_build, resolve_device)
from repro_torch.kernels.distance import pairwise_distance

# distances held at once: [b, chunk] f32 stays under 1 GiB
_SCAN_ELEMS = 1 << 28


# --------------------------------------------------------------------------
# Forest state
# --------------------------------------------------------------------------
def stack_trees(trees: list[TreeArrays]) -> TreeArrays:
    """One forest TreeArrays with a leading ``[n_shards]`` axis, every node
    table padded with zeros to the largest shard's ``max_nodes`` (as
    ``jnp.pad`` pads).  Padded rows are dead (``alive`` False) and so are
    never traversed; their ``free_list`` entries are 0, not -1, and are not
    in the shard's free ring (``free_head`` is unchanged)."""
    max_nodes = max(t.max_nodes for t in trees)
    stacked = {}
    for name in ARRAY_FIELDS:
        leaves = []
        for t in trees:
            leaf = getattr(t, name)
            if name in NODE_TABLE_FIELDS and t.max_nodes < max_nodes:
                pad = leaf.new_zeros((max_nodes - t.max_nodes,) + leaf.shape[1:])
                leaf = torch.cat([leaf, pad])
            leaves.append(leaf)
        stacked[name] = torch.stack(leaves)
    proto = trees[0]
    return TreeArrays(capacity=proto.capacity, dim=proto.dim,
                      metric=proto.metric, max_nodes=max_nodes,
                      min_fill=proto.min_fill, **stacked)


def unstack_forest(forest: TreeArrays,
                   max_nodes: list[int] | None = None) -> list[TreeArrays]:
    """The per-shard trees of a stacked forest (inverse of ``stack_trees``)
    as *views* of its tensors: a write to a shard (Insert/Delete,
    ``apply_mutations``) writes the forest.  ``max_nodes`` re-slices each
    shard's node table to its size before padding."""
    out = []
    for s in range(forest.root.shape[0]):
        n = forest.max_nodes if max_nodes is None else int(max_nodes[s])
        fields = {}
        for name in ARRAY_FIELDS:
            leaf = getattr(forest, name)[s]
            if name in NODE_TABLE_FIELDS:
                leaf = leaf[:n]
            fields[name] = leaf
        out.append(dataclasses.replace(forest, max_nodes=n, **fields))
    return out


def build_forest_trees(X: np.ndarray, n_shards: int, *, capacity: int = 32,
                       metric: str = "d_inf", seed: int = 0,
                       device=None) -> list[TreeArrays]:
    """Partition X round robin over ``n_shards`` (object i goes to shard
    i mod S, ids stay global) and bulk-build one SM-tree per shard on
    ``device`` (None = the card)."""
    device = resolve_device(device)
    X = np.asarray(X, np.float32)
    trees = []
    for s in range(n_shards):
        idx = np.arange(s, X.shape[0], n_shards)
        trees.append(bulk_build(X[idx], ids=idx, capacity=capacity,
                                metric=metric, seed=seed + s, device=device))
    return trees


def build_forest(X: np.ndarray, n_shards: int, *, capacity: int = 32,
                 metric: str = "d_inf", seed: int = 0,
                 device=None) -> TreeArrays:
    """``build_forest_trees``, stacked on one device (None = the card)."""
    return stack_trees(build_forest_trees(X, n_shards, capacity=capacity,
                                          metric=metric, seed=seed,
                                          device=device))


def place_forest(trees_or_forest, *, group=None, device=None) -> TreeArrays:
    """Make a forest resident where ``forest_knn`` and the fronts serve it:
    the read-replica fan-out step (stream/replica.py: a follower replays
    the WAL into per-shard trees, then each published epoch's shards are
    placed here and queried through the same fronts as the leader's).

    ``trees_or_forest`` is a list of per-shard trees or a stacked forest.
    Without ``group`` the shards are stacked (padded as ``stack_trees``
    pads) on ``device`` (None = the card).  With a ``torch.distributed``
    group there is one shard per rank: the result is this rank's shard,
    on ``device``, and the shard count must equal the group's size."""
    device = resolve_device(device)
    trees = (unstack_forest(trees_or_forest)
             if isinstance(trees_or_forest, TreeArrays) else list(trees_or_forest))
    if group is None:
        return stack_trees([_to_device(t, device) for t in trees])
    import torch.distributed as dist
    if dist.get_world_size(group) != len(trees):
        raise ValueError(f"the group has {dist.get_world_size(group)} ranks for "
                         f"{len(trees)} shards (need exactly one per shard)")
    return _to_device(trees[dist.get_rank(group)], device)


def promote_follower(replica, *, group=None, device=None,
                     expect: tuple[int, str] | None = None,
                     timeout: float = 30.0):
    """Bring a replayed follower into service: the failover endgame after
    ``stream.lease.promote`` hands it the WAL.

    ``replica`` is a ``stream.replica.Replica`` (or ``ShippedReplica``)
    whose follower is a ``StreamingForest`` (or a ``StreamingEngine``: one
    shard); ``expect`` is the leader's last ``(seq, digest)`` digest
    exchange when known — the follower must catch up through it and match
    bitwise before its shards may serve (``DigestMismatch`` otherwise; a
    diverged replica would silently answer queries from a different
    index).  Returns ``(placed, epoch)``: the pinned epoch's shards made
    resident by :func:`place_forest` (stacked on ``device``, or this
    rank's shard with ``group``), and the epoch number they came from, for
    the router's session-token stamping."""
    if expect is not None:
        seq, digest = expect
        replica.verify(seq, digest, timeout=timeout)
    with replica.epochs.reading(with_epoch=True) as (epoch, pinned):
        shards = list(pinned) if isinstance(pinned, (tuple, list)) else [pinned]
        placed = place_forest(shards, group=group, device=device)
    return placed, epoch


def _to_device(tree: TreeArrays, device) -> TreeArrays:
    return dataclasses.replace(
        tree, **{f: getattr(tree, f).to(device) for f in ARRAY_FIELDS})


def common_static_height(forest: TreeArrays) -> int | None:
    """The height every shard shares, or None when the shards' heights
    differ (the cohort descent needs one height; unequal shards fall back
    to the per-query engine)."""
    heights = forest.height.reshape(-1).tolist()
    if heights and all(h == heights[0] for h in heights):
        return int(heights[0])
    return None


# --------------------------------------------------------------------------
# Queries
# --------------------------------------------------------------------------
def _merge_topk(all_d: torch.Tensor, all_i: torch.Tensor, k: int):
    """k-way merge of per-shard candidates ``[S, b, k]``: laid out
    shard-major per query (``[b, S*k]``), then the k smallest by a stable
    sort, so equal distances keep the lowest shard, then the lowest rank."""
    S, b, kk = all_d.shape
    flat_d = all_d.transpose(0, 1).reshape(b, S * kk)
    flat_i = all_i.transpose(0, 1).reshape(b, S * kk)
    vals, sel = smtree._smallest(flat_d, k)
    return vals, flat_i.gather(1, sel)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def _local_knn(tree: TreeArrays, queries: torch.Tensor, k: int, F: int,
               height: int | None, prune: bool, scorer):
    if height is None:
        return smtree._knn_perquery(tree, queries, k, F, smtree._INF)
    return smtree._knn_cohort(tree, queries, smtree._INF, k=k, F=F,
                              height=height, prune=prune, scorer=scorer)


def forest_knn(forest: TreeArrays, queries, *, k: int = 8,
               max_frontier: int = 64, parent_prune: bool | None = None,
               group=None, _scorer=None):
    """Global kNN over the forest: (dists [b, k] f32, ids [b, k] int32).

    Each shard runs the cohort descent over its tree when all shards share
    one height (``common_static_height``), and the per-query engine
    (``smtree._knn_perquery``) on every shard otherwise, as the reference
    does; the per-shard results are merged by ``_merge_topk``.
    ``parent_prune`` is resolved once (None: ``REPRO_PARENT_PRUNE``).

    ``forest`` is a stacked forest on one device, whose shards are
    searched one after another, or, with a ``torch.distributed`` process
    group, this rank's own tree: the ranks agree on the common height by
    an all-gather of heights and all-gather their candidates.  ``_scorer``
    is private, as in ``smtree.knn``."""
    prune = smtree._resolve_parent_prune(parent_prune)
    queries = smtree._as_queries(forest, queries)
    if group is None:
        height = common_static_height(forest)
        res = [_local_knn(t, queries, k, max_frontier, height, prune, _scorer)
               for t in unstack_forest(forest)]
        all_d = torch.stack([r.dists for r in res])
        all_i = torch.stack([r.ids for r in res])
    else:
        heights = _all_gather(forest.height.reshape(1), group).reshape(-1)
        height = (int(heights[0]) if bool((heights == heights[0]).all())
                  else None)
        r = _local_knn(forest, queries, k, max_frontier, height, prune,
                       _scorer)
        all_d, all_i = _all_gather(r.dists, group), _all_gather(r.ids, group)
    d, ids = _merge_topk(all_d, all_i, k)
    return d, ids.to(torch.int32)


def _scan_topk(X: torch.Tensor, queries: torch.Tensor, k: int, metric: str):
    """The k nearest rows of X by a full scan through the distance kernel,
    in chunks of entries when ``[b, n]`` distances do not fit at once;
    chunks merge in order, which keeps the lowest-index-first tie order."""
    b, n = queries.shape[0], X.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, n={n}]; got {k}")
    step = max(k, _SCAN_ELEMS // max(1, b))
    best_d = best_i = None
    for s in range(0, n, step):
        d = pairwise_distance(queries, X[s:s + step], metric)
        kk = min(k, d.shape[1])
        vals, idx = torch.sort(d, dim=1, stable=True)
        vals, idx = vals[:, :kk], idx[:, :kk] + s
        if best_d is not None:
            vals = torch.cat([best_d, vals], dim=1)
            idx = torch.cat([best_i, idx], dim=1)
            vals, sel = torch.sort(vals, dim=1, stable=True)
            vals, idx = vals[:, :k], idx.gather(1, sel[:, :k])
        best_d, best_i = vals, idx
    return best_d, best_i


def brute_force_knn(X, queries, *, k: int = 8, metric: str = "d_inf",
                    group=None, device=None):
    """Exact k-NN by a full scan (the paper's "sequential scan" line):
    (dists [b, k] f32, ids [b, k] int64) on ``device`` (None = the card; it
    raises without one).  ``X`` and ``queries`` (numpy or tensors on any
    device) are moved there.  Equal distances come back lowest index
    first, as ``jax.lax.top_k`` gives them.

    The reference's sharded form takes a ``torch.distributed`` process
    group: ``X`` is this rank's slice (every rank's of one size, rank r
    holding rows ``r*n .. (r+1)*n - 1``), each rank scans its slice and
    cuts it to its k best, and the per-rank candidates are all-gathered
    and merged by ``_merge_topk``.  The result equals the one-device
    scan's."""
    device = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=device)
    d, i = _scan_topk(X, queries, k, metric)
    if group is None:
        return d, i
    import torch.distributed as dist
    i = i + dist.get_rank(group) * X.shape[0]
    return _merge_topk(_all_gather(d, group), _all_gather(i, group), k)


# --------------------------------------------------------------------------
# Mutation fronts (each row acts on its owner shard; with a process group,
# this rank's shard, and the masked rows are summed over the ranks)
# --------------------------------------------------------------------------
def _local_shards(forest: TreeArrays, group) -> list[tuple[int, TreeArrays]]:
    """(shard index, tree) of every shard this process holds: all of a
    stacked forest's (as views), or this rank's own tree."""
    if group is None:
        return list(enumerate(unstack_forest(forest)))
    import torch.distributed as dist
    return [(dist.get_rank(group), forest)]


def _sum_over_ranks(t: torch.Tensor, group) -> torch.Tensor:
    """The reference's ``psum``: a sum over the group's ranks, in place
    (no-op without a group)."""
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def forest_delete(forest: TreeArrays, xs, oids, *, group=None):
    """Delete a batch of ids from every shard that holds them, in place,
    through the no-underflow fast path (``smtree.delete_fast``): a row that
    would underflow leaves its shard as it was.  Returns (forest, found
    [n] bool): found where some shard deleted the id.  With a process
    group, ``forest`` is this rank's tree and ``found`` is summed over the
    ranks."""
    dev = forest.device
    xs = torch.as_tensor(xs, dtype=torch.float32, device=dev)
    oids = torch.as_tensor(oids, dtype=torch.int32, device=dev).reshape(-1)
    oids_h = oids.cpu().tolist()
    found = np.zeros(len(oids_h), np.int32)
    for _, t in _local_shards(forest, group):
        # an id absent from a shard before the batch stays absent: only
        # the rows it may hold run the fast path
        held = torch.isin(oids, t.oid[t.valid]).cpu().numpy()
        for i in np.nonzero(held)[0]:
            _, hit, underflow, _ = smtree.delete_fast(t, xs[i], oids_h[i])
            found[i] += hit and not underflow
    found = _sum_over_ranks(torch.from_numpy(found).to(dev), group)
    return forest, found > 0


def _validate_cohort(oids) -> None:
    """The cohort contract on the host: unique, non-negative ids."""
    oids_np = np.asarray(torch.as_tensor(oids).cpu())
    if len(np.unique(oids_np)) != len(oids_np):
        raise ValueError(
            "forest_apply_mutations requires unique oids per batch "
            "(conflict-free cohort)")
    if len(oids_np) and int(oids_np.min()) < 0:
        raise ValueError("negative object ids are reserved (NOP pad "
                         "sentinel)")


def _owner_routed(forest: TreeArrays, owner, group, run) -> torch.Tensor:
    """statuses [B] int32 of ``run(tree, rows)`` on each held shard's own
    rows (``owner[i]`` names the shard), ST_NOP (0) on rows no shard owns,
    summed over the ranks of ``group``."""
    dev = forest.device
    owner_h = np.asarray(torch.as_tensor(owner).cpu(), np.int64).reshape(-1)
    status = torch.zeros(len(owner_h), dtype=torch.int32, device=dev)
    for s, t in _local_shards(forest, group):
        rows = torch.from_numpy(np.nonzero(owner_h == s)[0]).to(dev)
        if len(rows):
            status[rows] = run(t, rows).to(dev)
    return _sum_over_ranks(status, group)


def _rows(dev, ops, xs, oids):
    """A batch's ops, xs (when given) and oids as tensors on ``dev``."""
    return (torch.as_tensor(ops, dtype=torch.int32, device=dev).reshape(-1),
            None if xs is None else torch.as_tensor(xs, dtype=torch.float32,
                                                    device=dev),
            torch.as_tensor(oids, dtype=torch.int32, device=dev).reshape(-1))


def forest_apply_mutations(forest: TreeArrays, ops, xs, oids, owner, *,
                           validate: bool = False, group=None):
    """A mixed insert/delete batch, in place: row i goes to shard
    ``owner[i]`` only, through ``smtree.apply_mutations`` with splits and
    merges off (as the reference's collective runs it; the overflow and
    underflow rows go to ``forest_apply_splits``/``forest_apply_merges``).
    Returns (forest, statuses [B] int32): the owner's status, ST_NOP (0)
    where ``owner`` names no shard.  The batch must be a conflict-free
    cohort (unique, non-negative ids); ``validate=True`` checks that first.
    With a process group, ``forest`` is this rank's tree (shard = rank)."""
    if validate:
        _validate_cohort(oids)
    ops, xs, oids = _rows(forest.device, ops, xs, oids)

    def run(t, r):
        return smtree.apply_mutations(t, ops[r], xs[r], oids[r],
                                      splits=False, merges=False)[1]

    return forest, _owner_routed(forest, owner, group, run)


def forest_apply_splits(forest: TreeArrays, ops, xs, oids, owner, *,
                        group=None):
    """The forest's split front, in place: a compacted batch of ST_OVERFLOW
    insert rows (log order, owner-routed as in ``forest_apply_mutations``)
    through each shard's device split pass (``smtree.apply_splits``).
    Returns (forest, statuses [K] int32): ST_SPLIT where the owner absorbed
    the row, ST_OVERFLOW where its ring blocked (and on its later rows),
    ST_NOP where no shard owns the row.  With a process group, ``forest``
    is this rank's tree."""
    ops, xs, oids = _rows(forest.device, ops, xs, oids)

    def run(t, r):
        return smtree.apply_splits(t, ops[r], xs[r], oids[r])[1]

    return forest, _owner_routed(forest, owner, group, run)


def forest_apply_merges(forest: TreeArrays, ops, oids, owner, *, group=None):
    """The forest's merge front, in place: a compacted batch of
    ST_UNDERFLOW delete rows (log order, owner-routed) through each shard's
    device merge pass (``smtree.apply_merges``), which locates targets by
    id alone.  Returns (forest, statuses [K] int32): ST_MERGE where the
    owner absorbed the row, ST_NOTFOUND where it does not hold the id,
    ST_NOP where no shard owns the row.  With a process group, ``forest``
    is this rank's tree."""
    ops, _, oids = _rows(forest.device, ops, None, oids)

    def run(t, r):
        return smtree.apply_merges(t, ops[r], oids[r])[1]

    return forest, _owner_routed(forest, owner, group, run)


def forest_extract_objects(forest: TreeArrays, oids, owner, *, group=None):
    """Owner-routed gather of stored vectors: shard ``owner[i]`` looks up
    ``oids[i]`` (``smtree.extract_objects``).  Returns (vecs [B, dim] f32,
    found [B] bool), zero rows where the owner does not hold the id.  The
    vectors are a sum over shards of the masked rows, as the reference's
    ``psum``: with two or more shards a stored -0.0 comes back +0.0.  With
    a process group, ``forest`` is this rank's tree and the sum runs over
    the ranks."""
    dev = forest.device
    oids = torch.as_tensor(oids, dtype=torch.int32, device=dev).reshape(-1)
    owner = torch.as_tensor(owner, dtype=torch.int32, device=dev).reshape(-1)
    vecs = hits = None
    for s, t in _local_shards(forest, group):
        mine = owner == s
        v, f = smtree.extract_objects(t, torch.where(mine, oids, -1))
        f = f & mine
        v = torch.where(f[:, None], v, 0.0)
        vecs = v if vecs is None else vecs + v
        hits = f.int() if hits is None else hits + f.int()
    vecs, hits = _sum_over_ranks(vecs, group), _sum_over_ranks(hits, group)
    return vecs, hits > 0
