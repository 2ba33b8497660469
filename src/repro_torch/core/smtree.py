"""SM-tree engine in PyTorch: tree state, bulk build, cohort kNN/range
descent, the Insert/Delete fast paths, the batched mutation scan and the
device split and merge passes.

Port of ``repro/core/smtree.py``.  The tree is the reference's fixed-
capacity structure of arrays (one row per node, one lane per entry), held
as a dataclass of tensors with the same 16 array fields — names, order and
dtypes (f32 / int32 / bool) — and the same 5 meta fields, so one tree
converts to the other field for field (core/convert.py).

Queries run the reference's level-synchronous cohort descent: every level
scores all entries of all frontier nodes of all queries in one call of the
frontier scorer (kernels/frontier.py: the CUDA kernel on the card, the
plain version on the CPU), prunes with the triangle inequality, and
compacts the survivors into the next frontier with a fixed-size selection.
Eager PyTorch always knows the tree's height, so ``knn`` always takes the
cohort path; the reference's per-query engine (``_knn_perquery``) is kept
for the forest, which falls back to it when its shards' heights differ
(core/distributed.py), and as the benchmark baseline.

Differences from JAX carried over deliberately (each marked where handled):

  * ``jax.lax.top_k`` returns equal values lowest index first;
    ``torch.topk`` promises no order among ties.  Every selection here is a
    stable ascending sort, sliced (``_smallest``).
  * ``jnp.argmin``/``jnp.argmax`` take the first hit; so do
    ``torch.argmin``/``torch.argmax`` (documented), which do not take bool,
    hence the casts.
  * JAX sums with ``dtype=jnp.int32``; torch sums bool to int64, so every
    count passes ``dtype=torch.int32``.
  * Index fields stay int32 and are cast to int64 only at a gather.
  * JAX clamps out-of-range gathers and torch raises: every clamp of the
    reference is kept.

Insert/Delete, the batched mutation apply (``apply_mutations``) and the
split and merge passes (``apply_splits``, ``apply_merges``) mutate the
tree's tensors in place (the reference returns a new pytree): the engine
replaces its tree after each operation anyway, and in place a write
touches a few rows instead of copying every array.  The per-tree scalars
(``root``, ``height``, ``free_head``, ``n_nodes``) are written with
``fill_``/``add_``, never rebound, because a forest shard's scalars are
views into the stacked forest (core/distributed.py).  Only ``grow_tree``
returns a new tree: it changes the shapes.
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from repro_torch.core.metric import get_metric, make_metric
from repro_torch.core.split import min_side_for
from repro_torch.kernels.frontier import frontier_scores

MAX_HEIGHT = 16          # supports capacity^15 objects; plenty
_INF = float("inf")
# prune-test pad: a directly computed distance can exceed the folded SM
# radius by an ulp, so borderline subtrees are visited, never pruned
_EPS = 1e-5
# leaf-level chunk count of the cohort descent (a schedule knob: results
# are exact for any value >= 1; see _knn_cohort)
_LEAF_CHUNKS = 4

ARRAY_FIELDS = ("vecs", "radius", "pdist", "child", "oid", "valid", "count",
                "is_leaf", "alive", "parent", "pslot", "root", "n_nodes",
                "height", "free_list", "free_head")
META_FIELDS = ("capacity", "dim", "metric", "max_nodes", "min_fill")
# the fields with one row per node ([max_nodes, ...] in a tree); the rest
# are per-tree scalars
NODE_TABLE_FIELDS = ("vecs", "radius", "pdist", "child", "oid", "valid",
                     "count", "is_leaf", "alive", "parent", "pslot",
                     "free_list")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  No entry point falls back to the CPU on its
    own: without a CUDA device the caller must pass ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


# --------------------------------------------------------------------------
# Tree state
# --------------------------------------------------------------------------
@dataclasses.dataclass
class TreeArrays:
    vecs: torch.Tensor      # [N, cap, dim] f32 — entry reference values
    radius: torch.Tensor    # [N, cap] f32 — covering radii (0 at leaf entries)
    pdist: torch.Tensor     # [N, cap] f32 — d(entry, parent routing object)
    child: torch.Tensor     # [N, cap] i32 — child node id; -1 for leaf entries
    oid: torch.Tensor       # [N, cap] i32 — object id at leaf entries; -1 else
    valid: torch.Tensor     # [N, cap] bool
    count: torch.Tensor     # [N] i32
    is_leaf: torch.Tensor   # [N] bool
    alive: torch.Tensor     # [N] bool — allocated node slots
    parent: torch.Tensor    # [N] i32 — parent node id (-1 at root)
    pslot: torch.Tensor     # [N] i32 — slot within parent pointing here
    root: torch.Tensor      # [] i32
    n_nodes: torch.Tensor   # [] i32
    height: torch.Tensor    # [] i32
    free_list: torch.Tensor # [N] i32 — dead node ids, packed descending; -1 pad
    free_head: torch.Tensor # [] i32 — free_list[:free_head] live
    capacity: int
    dim: int
    metric: str
    max_nodes: int
    min_fill: int

    @property
    def device(self) -> torch.device:
        return self.vecs.device

    @property
    def n_objects(self) -> int:
        # the alive mask gates the count: freed node slots may keep stale
        # valid bits
        live = self.alive[:, None] & self.is_leaf[:, None] & self.valid
        return int(live.sum())

    @property
    def n_free_nodes(self) -> int:
        """Unallocated node slots (free-list headroom for splits)."""
        return int((~self.alive).sum())


def clone_tree(tree: TreeArrays) -> TreeArrays:
    """A copy of ``tree`` (a tree or a stacked forest) whose tensors share
    nothing with it, on the same device: what a writer takes before it
    writes a version that a reader may hold (stream/batcher.py)."""
    return dataclasses.replace(
        tree, **{f: getattr(tree, f).clone() for f in ARRAY_FIELDS})


def packed_free_list(alive) -> tuple[np.ndarray, np.ndarray]:
    """Free-ring representation of the dead node set: dead ids in
    descending order, so the top of the stack is the lowest free id (what
    the host allocator picks)."""
    alive = np.asarray(alive)
    free = np.nonzero(~alive)[0][::-1].astype(np.int32)
    out = np.full(alive.shape[0], -1, np.int32)
    out[:len(free)] = free
    return out, np.int32(len(free))


def tree_from_numpy(arrays: dict, meta: dict, device) -> TreeArrays:
    """TreeArrays on ``device`` from the 16 array fields (numpy or any
    array-like) and the 5 meta fields of any SM-tree, the JAX package's
    included; dtypes are cast to f32 / int32 / bool field by field, and a
    missing field raises ``KeyError``."""
    device = torch.device(device)
    out = {}
    dtypes = {"f": np.float32, "i": np.int32, "u": np.int32, "b": np.bool_}
    for name in ARRAY_FIELDS:
        a = np.asarray(arrays[name])
        if a.dtype.kind not in dtypes:
            raise TypeError(f"{name}: unsupported dtype {a.dtype}")
        # a C-ordered copy (0-d scalars stay 0-d) that torch may own
        a = np.array(a, dtype=dtypes[a.dtype.kind], order="C")
        out[name] = torch.from_numpy(a).to(device)
    return TreeArrays(**out, **{k: meta[k] for k in META_FIELDS})


def empty_tree(*, dim: int, capacity: int = 32, max_nodes: int = 1024,
               metric: str = "d_inf", min_fill_frac: float = 0.4,
               device=None) -> TreeArrays:
    device = resolve_device(device)
    cap, N = capacity, max_nodes
    alive = np.zeros((N,), bool)
    alive[0] = True
    free_list, free_head = packed_free_list(alive)
    arrays = dict(
        vecs=np.zeros((N, cap, dim), np.float32),
        radius=np.zeros((N, cap), np.float32),
        pdist=np.zeros((N, cap), np.float32),
        child=np.full((N, cap), -1, np.int32),
        oid=np.full((N, cap), -1, np.int32),
        valid=np.zeros((N, cap), bool),
        count=np.zeros((N,), np.int32),
        is_leaf=np.ones((N,), bool),
        alive=alive,
        parent=np.full((N,), -1, np.int32),
        pslot=np.full((N,), -1, np.int32),
        root=np.int32(0), n_nodes=np.int32(1), height=np.int32(1),
        free_list=free_list, free_head=free_head)
    meta = dict(capacity=cap, dim=dim, metric=metric, max_nodes=N,
                min_fill=max(1, math.ceil(min_fill_frac * cap)))
    return tree_from_numpy(arrays, meta, device)


def _metric_eval(metric: str, q, e):
    """q: [..., d]; e: [..., d] broadcast; returns distances [...]."""
    try:
        fn = get_metric(metric)
    except KeyError:
        raise ValueError(metric) from None
    return fn(q, e)


# --------------------------------------------------------------------------
# Bulk build (host-side, numpy): balanced bottom-up construction
# --------------------------------------------------------------------------
def bulk_build(X: np.ndarray, ids: np.ndarray | None = None, *,
               capacity: int = 32, metric: str = "d_inf",
               fill_frac: float = 0.7, min_fill_frac: float = 0.4,
               seed: int = 0, slack: float = 1.5, device=None) -> TreeArrays:
    """Construct a valid SM-tree over X [n, d] (balanced recursive-bisection
    grouping, medoid routing objects, exact SM radii) on the host with
    numpy, then move the arrays to ``device`` (the card by default)."""
    device = resolve_device(device)
    mfn = make_metric(metric, None)
    X = np.asarray(X, np.float32)
    n, dim = X.shape
    ids = np.arange(n, dtype=np.int64) if ids is None else np.asarray(ids)
    target = max(2, int(capacity * fill_frac))
    min_fill = max(1, math.ceil(min_fill_frac * capacity))
    rng = np.random.default_rng(seed)

    def group(indices: np.ndarray, tgt: int, pts: np.ndarray) -> list[np.ndarray]:
        """Partition ``indices`` into groups of near-equal size by recursive
        2-pivot bisection; parts is capped at n // min_fill so every group
        meets the min-fill floor."""
        n_idx = len(indices)
        parts = min(-(-n_idx // tgt), n_idx // min_fill)
        if parts <= 1:
            return [indices]
        P = pts[indices]
        a = int(rng.integers(n_idx))
        da = mfn(P[a][None, :], P)
        b = int(np.argmax(da))
        db = mfn(P[b][None, :], P)
        order = np.argsort(da - db, kind="stable")   # closest-to-a first
        left_parts = parts // 2
        cut = round(n_idx * left_parts / parts)
        return (group(indices[order[:cut]], tgt, pts)
                + group(indices[order[cut:]], tgt, pts))

    leaf_groups = group(np.arange(n), target, X)
    nodes: list[dict] = []

    def medoid(P: np.ndarray, extra: np.ndarray | None = None) -> int:
        D = np.asarray(mfn(P[:, None, :], P[None, :, :]))
        if extra is not None:
            D = D + extra[None, :]
        return int(D.max(axis=1).argmin())

    level_nodes = []   # (node_id, routing_vec, covering_radius)
    for g in leaf_groups:
        P = X[g]
        mi = medoid(P)
        d_to_m = np.asarray(mfn(P[mi][None, :], P))
        nid = len(nodes)
        nodes.append(dict(is_leaf=True, vecs=P, radius=np.zeros(len(g)),
                          pdist=d_to_m, oid=ids[g], child=np.full(len(g), -1)))
        level_nodes.append((nid, P[mi], float(d_to_m.max())))

    height = 1
    while len(level_nodes) > 1:
        height += 1
        routing = np.stack([v for _, v, _ in level_nodes])
        radii = np.array([r for _, _, r in level_nodes])
        nids = np.array([i for i, _, _ in level_nodes])
        parent_groups = group(np.arange(len(level_nodes)), target, routing)
        next_level = []
        for g in parent_groups:
            P = routing[g]
            rg = radii[g]
            mi = medoid(P, rg)
            d_to_m = np.asarray(mfn(P[mi][None, :], P))
            nid = len(nodes)
            nodes.append(dict(is_leaf=False, vecs=P, radius=rg, pdist=d_to_m,
                              oid=np.full(len(g), -1), child=nids[g]))
            next_level.append((nid, P[mi], float((d_to_m + rg).max())))
        level_nodes = next_level

    root = level_nodes[0][0]
    N = max(16, int(len(nodes) * slack))
    vecs = np.zeros((N, capacity, dim), np.float32)
    radius = np.zeros((N, capacity), np.float32)
    pdist = np.zeros((N, capacity), np.float32)
    child = np.full((N, capacity), -1, np.int32)
    oid = np.full((N, capacity), -1, np.int32)
    valid = np.zeros((N, capacity), bool)
    count = np.zeros((N,), np.int32)
    is_leaf = np.ones((N,), bool)
    parent = np.full((N,), -1, np.int32)
    pslot = np.full((N,), -1, np.int32)
    alive = np.zeros((N,), bool)
    alive[:len(nodes)] = True
    for i, nd in enumerate(nodes):
        m = len(nd["oid"])
        assert m <= capacity, (m, capacity)
        vecs[i, :m] = nd["vecs"]
        radius[i, :m] = nd["radius"]
        pdist[i, :m] = nd["pdist"]
        child[i, :m] = nd["child"]
        oid[i, :m] = nd["oid"]
        valid[i, :m] = True
        count[i] = m
        is_leaf[i] = nd["is_leaf"]
        if not nd["is_leaf"]:
            for s, c in enumerate(nd["child"]):
                parent[c] = i
                pslot[c] = s
    free_list, free_head = packed_free_list(alive)
    arrays = dict(vecs=vecs, radius=radius, pdist=pdist, child=child, oid=oid,
                  valid=valid, count=count, is_leaf=is_leaf, alive=alive,
                  parent=parent, pslot=pslot, root=np.int32(root),
                  n_nodes=np.int32(len(nodes)), height=np.int32(height),
                  free_list=free_list, free_head=free_head)
    meta = dict(capacity=capacity, dim=dim, metric=metric, max_nodes=N,
                min_fill=min_fill)
    return tree_from_numpy(arrays, meta, device)


# --------------------------------------------------------------------------
# Batched queries
# --------------------------------------------------------------------------
@dataclasses.dataclass
class QueryResult:
    dists: torch.Tensor      # [b, k] f32 (inf-padded)
    ids: torch.Tensor        # [b, k] int32 (-1-padded)
    page_hits: torch.Tensor  # [b] int32 nodes visited
    dist_evals: torch.Tensor # [b] int32 metric evaluations performed
    overflow: torch.Tensor   # [b] bool — frontier truncated (approximate)


_PARENT_PRUNE_VALUES = ("auto", "0", "1")


def _resolve_parent_prune(parent_prune: bool | None) -> bool:
    """None → the ``REPRO_PARENT_PRUNE`` env var ('auto'/'1' = on, the
    default: results are bitwise identical either way; '0' = off).  Any
    other value raises rather than silently running unfiltered."""
    if parent_prune is not None:
        return bool(parent_prune)
    v = os.environ.get("REPRO_PARENT_PRUNE", "auto")
    if v not in _PARENT_PRUNE_VALUES:
        raise ValueError(
            f"REPRO_PARENT_PRUNE must be one of {_PARENT_PRUNE_VALUES}; "
            f"got {v!r}")
    return v != "0"


def _as_queries(tree: TreeArrays, queries) -> torch.Tensor:
    return torch.as_tensor(queries, dtype=torch.float32,
                           device=tree.device).contiguous()


def knn(tree: TreeArrays, queries, *, k: int = 1, max_frontier: int = 64,
        level_stats: bool = False, parent_prune: bool | None = None,
        _scorer=None):
    """Batched k-NN on the tree's device: level-synchronous cohort descent.

    queries: [b, dim].  Exact when ``overflow`` is False; otherwise
    best-effort (closest-first truncation of the frontier).
    ``level_stats=True`` returns ``(QueryResult, (by_bound, by_parent))``,
    int32 stacks ``[n_internal_levels, b]`` and ``[height, b]`` of entries
    pruned by the d_min bound and by the parent-distance pre-filter.
    ``parent_prune`` toggles that pre-filter (results are bitwise identical
    on or off; only ``dist_evals`` changes).  ``_scorer`` is private: it
    replaces the frontier scorer (see ``_knn_cohort``)."""
    queries = _as_queries(tree, queries)
    return _query(tree, queries, k, max_frontier, _INF,
                  level_stats=level_stats,
                  parent_prune=_resolve_parent_prune(parent_prune),
                  scorer=_scorer)


def range_search(tree: TreeArrays, queries, radius, *, max_results: int = 128,
                 max_frontier: int = 64,
                 parent_prune: bool | None = None) -> QueryResult:
    """Batched range query: the closest ``max_results`` objects within
    ``radius`` (per-query or broadcast).  ``overflow`` is conservative: it
    is set whenever ``max_results`` rows come back."""
    queries = _as_queries(tree, queries)
    radius = torch.broadcast_to(
        torch.as_tensor(radius, dtype=torch.float32, device=tree.device),
        (queries.shape[0],))
    res = _query(tree, queries, max_results, max_frontier, radius,
                 parent_prune=_resolve_parent_prune(parent_prune))
    return _range_filter(res, radius, max_results)


def _range_filter(res: QueryResult, radius, max_results: int) -> QueryResult:
    keep = res.dists <= radius[:, None]
    return QueryResult(torch.where(keep, res.dists, _INF),
                       torch.where(keep, res.ids, -1),
                       res.page_hits, res.dist_evals,
                       res.overflow | (keep.sum(1) == max_results))


def _query(tree: TreeArrays, queries, k: int, F: int, r_cap, *,
           level_stats: bool = False, parent_prune: bool = True,
           scorer=None):
    """The cohort engine unrolls the descent over the tree's height, which
    eager PyTorch always knows (leaves all sit at one depth, so each level
    is either internal or the leaf level)."""
    return _knn_cohort(tree, queries, r_cap, k=k, F=F,
                       height=int(tree.height), level_stats=level_stats,
                       prune=parent_prune, scorer=scorer)


def _smallest(x: torch.Tensor, n: int):
    """The n smallest values of each row and their column indices, equal
    values lowest index first — the order ``jax.lax.top_k(-x, n)`` gives.
    ``torch.topk`` leaves ties unordered, so this is a stable sort."""
    vals, idx = torch.sort(x, dim=1, stable=True)
    return vals[:, :n], idx[:, :n]


def _kth_smallest(x: torch.Tensor, j: int) -> torch.Tensor:
    """The j-th smallest value of each row (a value: ties cannot matter)."""
    return torch.kthvalue(x, j, dim=1).values


def _knn_cohort(tree: TreeArrays, queries: torch.Tensor, r_cap, *, k: int,
                F: int, height: int, level_stats: bool = False,
                prune: bool = True, scorer=None):
    """Level-synchronous query-cohort descent (the reference's fast path).

    All ``b`` queries advance one level per step, sharing one frontier
    scoring and one batched compaction per level, with per-level frontier
    widths ``w(0)=1, w(l+1)=min(F, w(l)*cap)``.  The d_max bound ``ub`` is
    the j-th smallest d + r seen so far (+_EPS, j = ceil(k/min_fill^rem)),
    a true upper bound on the kth-NN distance; truncating to w_out slots
    can only lose a subtree whose d - r exceeds every kept one and is
    within r_q — exactly what ``overflow`` reports.

    ``prune`` turns on the parent-distance pre-filter: each frontier slot
    carries ``qpd`` = d(q, routing object) from the level that admitted it,
    and the scorer drops entries with ``|qpd - pdist| > r_q + r + pad``
    before the metric (the root level, which has no parent, always scores
    unfiltered).  The leaf level is scored in ``_LEAF_CHUNKS`` slices of
    the score-sorted frontier with a top-k merge between them, so r_q
    tightens before the far leaves are scored.

    ``scorer`` is private: None means ``frontier_scores`` (the kernel on
    CUDA tensors).  Only the on-card comparison of the kernel path with
    the plain path passes ``frontier_scores_torch``."""
    scorer = frontier_scores if scorer is None else scorer
    dev = queries.device
    i32 = torch.int32
    b = queries.shape[0]
    cap = tree.capacity
    r_cap = torch.broadcast_to(
        torch.as_tensor(r_cap, dtype=torch.float32, device=dev), (b,))

    widths = [1]
    for _ in range(height - 1):
        widths.append(min(F, widths[-1] * cap))

    internal_valid = tree.valid & ~tree.is_leaf[:, None]
    leaf_valid = tree.valid & tree.is_leaf[:, None]

    frontier = tree.root.reshape(1, 1).expand(b, 1).contiguous()
    qpd = torch.full((b, 1), _INF, dtype=torch.float32, device=dev)
    topk_d = torch.full((b, k), _INF, dtype=torch.float32, device=dev)
    topk_i = torch.full((b, k), -1, dtype=i32, device=dev)
    ub = torch.full((b,), _INF, dtype=torch.float32, device=dev)
    page_hits = torch.zeros((b,), dtype=i32, device=dev)
    dist_evals = torch.zeros((b,), dtype=i32, device=dev)
    overflow = torch.zeros((b,), dtype=torch.bool, device=dev)
    pruned_levels = []          # level_stats only: [b] per internal level
    parent_levels = []          # level_stats only: [b] per level

    for lvl in range(height):
        w = widths[lvl]
        fvalid = frontier >= 0                              # [b, w]
        # the reference's jnp.maximum(frontier, 0); int64 only for the gather
        nodes = frontier.clamp(min=0).long()
        # JAX sums with dtype=int32; torch would sum bool to int64
        page_hits += fvalid.sum(1, dtype=i32)

        use_filter = prune and lvl > 0
        if lvl > 0:
            # pre-eval kth-NN upper bound from parent distances alone: two
            # triangle hops give d(q, x) <= qpd + pdist(e) + r(e) for every
            # object under entry e; it feeds r_q identically with the
            # filter on and off
            pd_ub = tree.pdist[nodes] + tree.radius[nodes]   # [b, w, cap]
            ok = tree.valid[nodes] & fvalid[:, :, None]
            ubnd = torch.where(ok, qpd[:, :, None] + pd_ub,
                               _INF).reshape(b, w * cap)
            j_pre = -(-k // max(1, tree.min_fill) ** (height - 1 - lvl))
            if j_pre == 1:
                ub = torch.minimum(ub, ubnd.amin(1) + _EPS)
            elif j_pre <= w * cap:
                ub = torch.minimum(ub, _kth_smallest(ubnd, j_pre) + _EPS)

        if lvl < height - 1:
            if use_filter:
                # pre-level query radius: conservative for the filter (the
                # level's own r_q can only be smaller)
                rq_pre = torch.minimum(torch.minimum(topk_d[:, k - 1], r_cap),
                                       ub)
                filt = dict(pdist=tree.pdist, qpd=qpd, rq=rq_pre)
            else:
                filt = {}
            dmax, score, leaf_d, dq = scorer(
                frontier, queries, tree.vecs, tree.radius, internal_valid,
                leaf_valid, metric=tree.metric, **filt)

            # evaluations performed: finite output <=> the metric ran
            performed = torch.isfinite(dmax) | torch.isfinite(leaf_d)
            n_eval = performed.sum((1, 2), dtype=i32)
            dist_evals += n_eval
            if level_stats:
                evalid = tree.valid[nodes] & fvalid[:, :, None]
                parent_levels.append(evalid.sum((1, 2), dtype=i32) - n_eval)
            # internal level: d_max bound, prune, compact the frontier
            dmax = dmax.reshape(b, w * cap)
            rem = height - 1 - lvl
            cover = max(1, tree.min_fill) ** rem
            j = -(-k // cover)
            if j == 1:
                ub = torch.minimum(ub, dmax.amin(1) + _EPS)
            elif j <= w * cap:
                ub = torch.minimum(ub, _kth_smallest(dmax, j) + _EPS)
            r_q = torch.minimum(torch.minimum(topk_d[:, k - 1], r_cap), ub)
            score = score.reshape(b, w * cap)
            # score is +inf at masked entries; < inf keeps them out of
            # imask while r_q is still infinite
            imask = (score <= r_q[:, None] + _EPS) & (score < _INF)
            if level_stats:
                pruned_levels.append(
                    (torch.isfinite(score) & ~imask).sum(1, dtype=i32))
            sc = torch.where(imask, score, _INF)
            childs = tree.child[nodes].reshape(b, w * cap)
            w_out = widths[lvl + 1]
            # stable selection: equal scores lowest index first, as top_k
            s_sel, order = _smallest(sc, w_out)
            sel_ok = s_sel < _INF
            frontier = torch.where(sel_ok, childs.gather(1, order),
                                   -1).contiguous()
            overflow |= imask.sum(1) > w_out
            # carry d(q, routing object) of each admitted entry: the next
            # level's d(q, parent)
            qpd = torch.where(sel_ok, dq.reshape(b, w * cap).gather(1, order),
                              _INF).contiguous()
        else:
            # leaf level: merge candidates into the running top-k, chunked
            # over the (score-sorted) frontier
            chw = -(-w // min(_LEAF_CHUNKS, w))
            parent_acc = torch.zeros((b,), dtype=i32, device=dev)
            for c0 in range(0, w, chw):
                fr_c = frontier[:, c0:c0 + chw].contiguous()
                nodes_c = nodes[:, c0:c0 + chw]
                wc = fr_c.shape[1]
                # per-chunk query radius: the same value with the filter on
                # or off
                r_q = torch.minimum(torch.minimum(topk_d[:, k - 1], r_cap), ub)
                filt = (dict(pdist=tree.pdist,
                             qpd=qpd[:, c0:c0 + chw].contiguous(), rq=r_q)
                        if use_filter else {})
                dmax_c, _, leaf_d, _ = scorer(
                    fr_c, queries, tree.vecs, tree.radius, internal_valid,
                    leaf_valid, metric=tree.metric, **filt)
                performed = torch.isfinite(dmax_c) | torch.isfinite(leaf_d)
                n_eval = performed.sum((1, 2), dtype=i32)
                dist_evals += n_eval
                if level_stats:
                    evalid = tree.valid[nodes_c] & (fr_c >= 0)[:, :, None]
                    parent_acc += evalid.sum((1, 2), dtype=i32) - n_eval
                leaf_d = leaf_d.reshape(b, wc * cap)
                cd = torch.where(leaf_d <= r_q[:, None], leaf_d, _INF)
                eoid = tree.oid[nodes_c].reshape(b, wc * cap)
                ci = torch.where(cd < _INF, eoid, -1)
                all_d = torch.cat([topk_d, cd], dim=1)
                all_i = torch.cat([topk_i, ci], dim=1)
                # stable selection: equal distances lowest index first
                topk_d, sel = _smallest(all_d, k)
                topk_i = all_i.gather(1, sel)
            if level_stats:
                parent_levels.append(parent_acc)

    res = QueryResult(topk_d, topk_i, page_hits, dist_evals, overflow)
    if level_stats:
        by_bound = (torch.stack(pruned_levels) if pruned_levels
                    else torch.zeros((0, b), dtype=i32, device=dev))
        return res, (by_bound, torch.stack(parent_levels))
    return res


def _knn_perquery(tree: TreeArrays, queries: torch.Tensor, k: int, F: int,
                  r_cap) -> QueryResult:
    """The reference's per-query engine (``vmap`` of a ``while_loop``), run
    for all ``b`` queries together, level by level.

    Each query keeps a frontier of ``F`` slots from the root down and, per
    level, scores every entry of its frontier nodes: the d_max bound (the
    k-th smallest d + r, +_EPS), leaf candidates merged into the running
    top-k (old entries first), then the ``F`` best surviving internal
    entries as the next frontier.  A query is active while its frontier is
    not empty; ``page_hits``, ``dist_evals`` (every valid entry of a
    visited node) and ``overflow`` grow only while it is.  Every
    ``lax.top_k`` of the reference is a stable sort here (``_smallest``).
    Plain torch ops: no kernel.  The forest falls back to it when its
    shards' heights differ (core/distributed.py:forest_knn)."""
    dev = queries.device
    i32 = torch.int32
    b = queries.shape[0]
    cap = tree.capacity
    r_cap = torch.broadcast_to(
        torch.as_tensor(r_cap, dtype=torch.float32, device=dev), (b,))
    frontier = torch.full((b, F), -1, dtype=i32, device=dev)
    frontier[:, 0] = tree.root
    topk_d = torch.full((b, k), _INF, dtype=torch.float32, device=dev)
    topk_i = torch.full((b, k), -1, dtype=i32, device=dev)
    ub = torch.full((b,), _INF, dtype=torch.float32, device=dev)
    page_hits = torch.zeros((b,), dtype=i32, device=dev)
    dist_evals = torch.zeros((b,), dtype=i32, device=dev)
    overflow = torch.zeros((b,), dtype=torch.bool, device=dev)

    for _ in range(int(tree.height)):
        fvalid = frontier >= 0                                   # [b, F]
        active = fvalid.any(1)
        if not bool(active.any()):
            break
        nodes = frontier.clamp(min=0).long()
        evalid = tree.valid[nodes] & fvalid[:, :, None]         # [b, F, cap]
        erad = tree.radius[nodes]
        leafy = tree.is_leaf[nodes][:, :, None]
        d = _metric_eval(tree.metric, queries[:, None, None, :],
                         tree.vecs[nodes])                       # [b, F, cap]
        page_hits += torch.where(active, fvalid.sum(1, dtype=i32), 0)
        dist_evals += torch.where(active, evalid.sum((1, 2), dtype=i32), 0)

        # d_max bound: the k-th smallest d + r over internal entries
        imask0 = evalid & ~leafy
        dmax = torch.where(imask0, d + erad, _INF).reshape(b, F * cap)
        ub = torch.minimum(ub, _kth_smallest(dmax, k) + _EPS)
        r_q = torch.minimum(torch.minimum(topk_d[:, k - 1], r_cap), ub)

        # leaf candidates -> the running top-k (old entries first)
        lmask = evalid & leafy & (d <= r_q[:, None, None])
        cd = torch.where(lmask, d, _INF).reshape(b, F * cap)
        ci = torch.where(lmask, tree.oid[nodes], -1).reshape(b, F * cap)
        topk_d, sel = _smallest(torch.cat([topk_d, cd], dim=1), k)
        topk_i = torch.cat([topk_i, ci], dim=1).gather(1, sel)
        r_q = torch.minimum(torch.minimum(topk_d[:, k - 1], r_cap), ub)

        # surviving internal entries -> the next frontier, closest first
        imask = imask0 & ((d - erad) <= r_q[:, None, None] + _EPS)
        score = torch.where(imask, d - erad, _INF).reshape(b, F * cap)
        s_sel, order = _smallest(score, F)
        childs = tree.child[nodes].reshape(b, F * cap)
        frontier = torch.where(s_sel < _INF, childs.gather(1, order), -1)
        overflow |= active & (imask.sum((1, 2)) > F)

    return QueryResult(topk_d, topk_i, page_hits, dist_evals, overflow)


# --------------------------------------------------------------------------
# Insert/Delete fast paths (in place; see the module docstring)
# --------------------------------------------------------------------------
def _descend_path(tree: TreeArrays, x: torch.Tensor):
    """SM-tree choose-subtree (closest entry) from root to leaf.  Returns
    (path_nodes, path_slots, leaf): two lists of MAX_HEIGHT ints, root
    first, -1 padded — the host loop needs the path as ints anyway."""
    pn = [-1] * MAX_HEIGHT
    ps = [-1] * MAX_HEIGHT
    node, lvl = int(tree.root), 0
    while not bool(tree.is_leaf[node]):
        d = _metric_eval(tree.metric, x[None, :], tree.vecs[node])
        d = torch.where(tree.valid[node], d, _INF)
        slot = int(torch.argmin(d))          # first minimum, as jnp.argmin
        pn[lvl], ps[lvl] = node, slot
        node = int(tree.child[node, slot])
        lvl += 1
    return pn, ps, node


def _refresh_path_radii(tree: TreeArrays, pn: list[int], ps: list[int]):
    """Bottom-up radius fold along the path (the SM invariant):
    r(entry at (pn[i], ps[i])) = max over its child's valid entries of
    pdist [+ radius]."""
    for lvl in reversed(range(MAX_HEIGHT)):
        n, s = pn[lvl], max(ps[lvl], 0)
        if n < 0:
            continue
        cn = max(int(tree.child[n, s]), 0)
        contrib = tree.pdist[cn] + torch.where(tree.is_leaf[cn], 0.0,
                                               tree.radius[cn])
        r = torch.where(tree.valid[cn], contrib, -_INF).amax()
        tree.radius[n, s] = r.clamp_min(0.0)


# The entry fields a leaf-slot write moves.  The engine's fast paths
# (``insert_fast``/``delete_fast``) write all five; the batched scan (the
# reference's ``_apply_row``) only the first three, since leaf radius and
# child rows hold 0.0 / -1 except for the stale bytes of a reused node row,
# which it leaves where they are.
_SLOT_FIELDS = ("vecs", "pdist", "oid", "radius", "child")
_SCAN_FIELDS = _SLOT_FIELDS[:3]


def insert_fast(tree: TreeArrays, x, obj_id: int, *,
                _fields: tuple = _SLOT_FIELDS):
    """No-split insert, in place.  Returns (tree, fits, leaf_id).  When the
    leaf is full the tree is left unchanged with fits=False — the caller
    runs the host-side split path.  ``_fields`` is private: the batched
    scan passes ``_SCAN_FIELDS``."""
    x = torch.as_tensor(x, dtype=torch.float32, device=tree.device)
    pn, ps, leaf = _descend_path(tree, x)
    cnt = int(tree.count[leaf])
    if cnt >= tree.capacity:
        return tree, False, leaf
    slot = cnt
    # parent routing vec: the entry pointing at `leaf` (deepest path entry)
    if pn[0] >= 0:
        plast = max(i for i in range(MAX_HEIGHT) if pn[i] >= 0)
        pvec = tree.vecs[pn[plast], ps[plast]]
        pd = _metric_eval(tree.metric, x, pvec)
    else:
        pd = 0.0
    values = dict(vecs=x, pdist=pd, oid=int(obj_id), radius=0.0, child=-1)
    for f in _fields:
        getattr(tree, f)[leaf, slot] = values[f]
    tree.valid[leaf, slot] = True
    tree.count[leaf] += 1
    _refresh_path_radii(tree, pn, ps)
    return tree, True, leaf


def path_to_root(tree: TreeArrays, leaf: int):
    """Climb parent pointers: (path_nodes, path_slots) root first, -1
    padded to MAX_HEIGHT — the layout of ``_descend_path``'s output."""
    chain_n, chain_s = [], []
    node = leaf
    while int(tree.parent[node]) >= 0:
        chain_n.append(int(tree.parent[node]))
        chain_s.append(int(tree.pslot[node]))
        node = chain_n[-1]
    pad = [-1] * (MAX_HEIGHT - len(chain_n))
    return chain_n[::-1] + pad, chain_s[::-1] + pad


def _swap_remove(tree: TreeArrays, leaf: int, slot: int,
                 fields: tuple = _SLOT_FIELDS):
    """Remove entry ``slot`` of ``leaf``, in place: the leaf's last entry
    fills the hole (``fields`` of it), then the tail slot is cleared (this
    order handles slot == last), and the radii along the path to the root
    are refreshed."""
    last = int(tree.count[leaf]) - 1
    for f in fields:
        a = getattr(tree, f)
        a[leaf, slot] = a[leaf, last].clone()
    tree.valid[leaf, last] = False
    tree.oid[leaf, last] = -1
    tree.count[leaf] -= 1
    _refresh_path_radii(tree, *path_to_root(tree, leaf))


def delete_fast(tree: TreeArrays, x, obj_id: int):
    """No-underflow delete, in place.  Returns (tree, found, underflow,
    leaf_id).  On underflow the tree is left unchanged with underflow=True —
    the caller runs the host-side merge path.  The object is located by
    exact id match; negative ids (the pad sentinel) never match."""
    obj_id = int(obj_id)
    hit = (tree.oid == obj_id) & tree.valid & (obj_id >= 0)
    # first hit in row-major order, as jnp.argmax over a bool mask;
    # torch.argmax takes no bool, hence the cast
    flat = int(torch.argmax(hit.reshape(-1).to(torch.uint8)))
    found = bool(hit.reshape(-1)[flat])
    leaf, slot = flat // tree.capacity, flat % tree.capacity
    if not found:
        return tree, False, False, leaf
    cnt = int(tree.count[leaf])
    # the root never underflows
    if cnt - 1 < tree.min_fill and leaf != int(tree.root):
        return tree, True, True, leaf
    _swap_remove(tree, leaf, slot)
    return tree, True, False, leaf


# --------------------------------------------------------------------------
# Mutation opcodes and per-row outcomes (the reference's stream data plane)
# --------------------------------------------------------------------------
OP_NOP, OP_INSERT, OP_DELETE = 0, 1, 2
ST_NOP, ST_APPLIED, ST_OVERFLOW, ST_UNDERFLOW, ST_NOTFOUND = 0, 1, 2, 3, 4
ST_SPLIT = 5
ST_MERGE = 6


def _delete_row(tree: TreeArrays, oid: int, leaf: int, found: bool) -> int:
    """The delete half of the reference's ``_apply_row``, in place: the
    target's leaf was located before the batch (``_locate_oids``), its slot
    is re-derived from the live row (an earlier swap-remove may have moved
    it), and the last entry fills the hole before the tail is cleared."""
    if not found:
        return ST_NOTFOUND
    row_hit = (tree.oid[leaf] == oid) & tree.valid[leaf]
    slot = int(torch.argmax(row_hit.to(torch.uint8)))   # first hit
    if int(tree.count[leaf]) - 1 < tree.min_fill and leaf != int(tree.root):
        return ST_UNDERFLOW
    _swap_remove(tree, leaf, slot, _SCAN_FIELDS)
    return ST_APPLIED


def _locate_slots(tree: TreeArrays, oids):
    """For each requested id, the flat slot ``node * cap + slot`` that holds
    it (``N * cap`` when absent) and a found mask, by one sorted join of the
    whole table against the batch.  The lowest flat slot wins, and a
    negative requested id (the pad sentinel) never matches.  Requires the
    batch's ids to be unique (the conflict-free-cohort contract)."""
    oids = torch.as_tensor(oids, dtype=torch.int32, device=tree.device)
    B = oids.shape[0]
    N, cap = tree.oid.shape
    if B == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=tree.device),
                torch.zeros((0,), dtype=torch.bool, device=tree.device))
    sorted_oids, order = torch.sort(oids, stable=True)
    pos = torch.searchsorted(sorted_oids, tree.oid).clamp(max=B - 1)
    cand = sorted_oids[pos]
    match = (cand == tree.oid) & tree.valid & (cand >= 0)
    row = torch.where(match, order[pos], B).reshape(-1)   # B: dropped
    flat = torch.arange(N * cap, dtype=torch.int64, device=tree.device)
    first = torch.full((B + 1,), N * cap, dtype=torch.int64,
                       device=tree.device)
    first = first.scatter_reduce(0, row, flat, "amin")[:B]
    return first.to(torch.int32), first < N * cap


def _locate_oids(tree: TreeArrays, oids):
    """The node holding each requested id (-1 when absent) and a found
    mask: ``_locate_slots`` at node granularity."""
    first, found = _locate_slots(tree, oids)
    return torch.where(found, first // tree.capacity, -1), found


def extract_objects(tree: TreeArrays, oids):
    """The stored vectors of a batch of unique ids (-1 pads never match):
    (vecs [B, dim] f32, found [B] bool), zero rows where an id is not live.
    A stored -0.0 comes back as -0.0."""
    N, cap = tree.oid.shape
    first, found = _locate_slots(tree, oids)
    flat_vecs = tree.vecs.reshape(N * cap, -1)
    rows = flat_vecs[first.clamp(max=N * cap - 1).long()]
    return torch.where(found[:, None], rows, 0.0), found




def apply_mutations(tree: TreeArrays, ops, xs, oids, *, splits: bool = True,
                    merges: bool = True):
    """Batched insert/delete apply, in place (the port's contract, as for
    ``insert_fast``/``delete_fast``): returns (tree, statuses [B] int32),
    the tree being the argument itself.

    ops: [B] opcodes (OP_INSERT, OP_DELETE; anything else is a NOP), xs:
    [B, dim], oids: [B] ids, applied in log order.  The batch must be a
    conflict-free cohort: no id twice.  Delete targets are located once,
    against the pre-batch tree; the insert descent reads internal rows,
    which no fast-path write touches, so it sees the pre-batch routing
    pages as the reference's does.  Rows the fast path cannot absorb leave
    the tree as it was and report ST_OVERFLOW / ST_UNDERFLOW /
    ST_NOTFOUND; NOP rows report ST_NOP.  Statuses and tree bytes are the
    reference scan's (``repro/core/smtree.py:_apply_row``); its branch-free
    masked writes are host branches here, one row at a time: an insert row
    is ``insert_fast``, a delete row ``_delete_row``, each moving only the
    slot fields that ``_apply_row`` moves (``_SCAN_FIELDS``: the stale
    radius of a reused node row stays where it is).

    With ``splits`` the overflow rows then go through the device split pass
    (``resolve_overflows``) and come back ST_SPLIT where it absorbed them.
    With ``merges`` the underflow rows then go through the device merge
    pass (``resolve_underflows``, ST_MERGE), but only when no ST_OVERFLOW
    row is left: the host plane (stream/batcher.py:escalate_rows) resolves
    every overflow before any underflow, and the passes keep its order."""
    ops_h = np.asarray(torch.as_tensor(ops).cpu(), np.int64).reshape(-1)
    oids_t = torch.as_tensor(oids, dtype=torch.int32,
                             device=tree.device).reshape(-1)
    oids_h = oids_t.cpu().tolist()
    xs = torch.as_tensor(xs, dtype=torch.float32, device=tree.device)
    status = np.zeros(len(ops_h), np.int32)
    dels = np.nonzero(ops_h == OP_DELETE)[0]
    if len(dels):
        leaf0, found0 = _locate_oids(tree, oids_t)
        leaf0, found0 = leaf0.cpu().tolist(), found0.cpu().tolist()
    for i, op in enumerate(ops_h.tolist()):
        if op == OP_INSERT:
            _, fits, _ = insert_fast(tree, xs[i], oids_h[i],
                                     _fields=_SCAN_FIELDS)
            status[i] = ST_APPLIED if fits else ST_OVERFLOW
        elif op == OP_DELETE:
            status[i] = _delete_row(tree, oids_h[i], leaf0[i], found0[i])
    if splits:
        _, status, _ = resolve_overflows(tree, ops_h, xs, oids_h, status)
    if merges and not (status == ST_OVERFLOW).any():
        _, status, _ = resolve_underflows(tree, ops_h, oids_h, status)
    return tree, torch.from_numpy(status).to(tree.device)


def move_objects(donor: TreeArrays, receiver: TreeArrays, oids, *,
                 splits: bool = True, merges: bool = True):
    """Re-home ``oids`` from ``donor`` into ``receiver``, both in place:
    (donor, receiver, moved [B] bool).  Insert before delete, so a failed
    row leaves an object visible twice across the pair, never zero times;
    ids absent from the donor, or whose insert or delete did not apply,
    report ``moved`` False.  ``splits``/``merges`` as in
    ``apply_mutations``: an insert resolved by a split counts as placed, a
    delete resolved by a merge as moved."""
    oids = torch.as_tensor(oids, dtype=torch.int32, device=donor.device)
    vecs, found = extract_objects(donor, oids)
    ins_ops = torch.where(found, OP_INSERT, OP_NOP)
    receiver, st_i = apply_mutations(
        receiver, ins_ops, vecs, torch.where(found, oids, -1),
        splits=splits, merges=merges)
    st_i = st_i.to(donor.device)
    placed = found & ((st_i == ST_APPLIED) | (st_i == ST_SPLIT))
    donor, st_d = apply_mutations(
        donor, torch.where(placed, OP_DELETE, OP_NOP), vecs,
        torch.where(placed, oids, -1), splits=splits, merges=merges)
    return donor, receiver, placed & ((st_d == ST_APPLIED) | (st_d == ST_MERGE))


# --------------------------------------------------------------------------
# Device split and merge passes (in place; the reference's mesh-resident
# mutation control plane).  Its branch-free masked writes are host branches
# on a few scalars read per row and per level (parent, count, free_head,
# height); every node row stays on the tree's device.
# --------------------------------------------------------------------------
def _at(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``a[i]`` for a 0-d index tensor, as a gather (no host sync)."""
    return a.index_select(0, i.reshape(1).long()).squeeze(0)


def _promote_and_partition(t: TreeArrays, D, Radd, uvalid, n, min_side,
                           max_moves: int):
    """mM_RAD promotion + generalized-hyperplane partition of one pending
    entry set, decision for decision equal to core/split.py:minmax_split.

    D: [m, m] pairwise distances of the pending reference values; Radd:
    [m] the radius term of the scoring matrix C = D + Radd[None, :] (zeros
    for leaf sets); uvalid: [m] member mask (all true for a split's cap + 1
    rows, ``arange(2*cap) < n`` for a merge's union of two nodes); ``n``
    and ``min_side`` the member count and the floor per side.  Returns
    (pi, pj, sel_i, sel_j, pres_i, pres_j, n_i, n_j, r_i, r_j): the
    promoted indices, each half's [cap] member indices in the host's slot
    order with its occupancy mask, the halves' counts and covering radii.

    The pair search is the reference's masked upper-triangle argmin in
    row-major order over max(cand_ri, cand_rj): the first minimal pair, as
    np.argmin over triu_indices.  The sequential min-fill rebalance is
    ``max_moves`` masked steps (a step is a no-op once both sides hold
    ``min_side``); ``stamp`` records the move order so that a stable
    argsort gives the host's member order.  Tensors on the tree's device
    throughout: no host sync."""
    cap = t.capacity
    m = D.shape[0]
    dev = D.device
    i32 = torch.int32
    Cmat = D + Radd[None, :]                                     # [m, m]
    toi3 = D[:, None, :] <= D[None, :, :]                        # [m, m, m]
    kval = uvalid[None, None, :]
    cand_ri = torch.where(toi3 & kval, Cmat[:, None, :], -_INF).amax(-1)
    cand_rj = torch.where(~toi3 & kval, Cmat[None, :, :], -_INF).amax(-1)
    cand_ri = torch.where(torch.isfinite(cand_ri), cand_ri, 0.0)
    cand_rj = torch.where(torch.isfinite(cand_rj), cand_rj, 0.0)
    triu = torch.ones((m, m), dtype=torch.bool, device=dev).triu(1)
    best = torch.argmin(torch.where(triu & uvalid[None, :],
                                    torch.maximum(cand_ri, cand_rj),
                                    _INF).reshape(-1))
    pi = (best // m).to(i32)
    pj = (best % m).to(i32)
    Dpi = _at(D, pi)
    Dpj = _at(D, pj)
    mask = (Dpi <= Dpj) & uvalid
    stamp = torch.arange(m, dtype=i32, device=dev)
    for k in range(max_moves):
        n_i = mask.sum(dtype=i32)
        need_i = n_i < min_side
        do = need_i | ((n - n_i) < min_side)
        cand_i = torch.argmin(torch.where(mask | ~uvalid, _INF, Dpi))
        cand_j = torch.argmin(torch.where(mask, Dpj, _INF))
        mv = torch.where(need_i, cand_i, cand_j).reshape(1)
        mask = mask.index_put((mv,), torch.where(do, need_i, mask[mv]))
        stamp = stamp.index_put((mv,), torch.where(do, m + k, stamp[mv]))
    n_i = mask.sum(dtype=i32)
    n_j = (n - n_i).to(i32)
    big = 2 * m + 2
    ord_i = torch.argsort(torch.where(mask, stamp, big), stable=True)
    ord_j = torch.argsort(torch.where(mask | ~uvalid, big, stamp), stable=True)
    slots = torch.arange(cap, dtype=i32, device=dev)
    sel_i = ord_i[:cap].to(i32)    # n_i, n_j <= cap (min_side >= m - cap)
    sel_j = ord_j[:cap].to(i32)
    pres_i = slots < n_i
    pres_j = slots < n_j
    r_i = torch.where(pres_i, (Dpi + Radd)[sel_i.long()], -_INF).amax()
    r_j = torch.where(pres_j, (Dpj + Radd)[sel_j.long()], -_INF).amax()
    return pi, pj, sel_i, sel_j, pres_i, pres_j, n_i, n_j, r_i, r_j


def _write_half(t: TreeArrays, row: int, V, R, C, O, Dp, sel, pres, n):
    """The host's write_node: rewrite node ``row`` with the ``sel``-ordered
    members of the pending set.  Slots beyond the new count keep their
    stale vecs/radius/pdist as the host leaves them (oid/child/valid tails
    are scrubbed), and each member child's parent/pslot pointers are
    re-aimed (leaf members have child -1 and drop out)."""
    sel = sel.long()
    slots = torch.arange(t.capacity, dtype=torch.int32, device=t.device)
    t.vecs[row] = torch.where(pres[:, None], V[sel], t.vecs[row])
    t.radius[row] = torch.where(pres, R[sel], t.radius[row])
    t.pdist[row] = torch.where(pres, Dp[sel], t.pdist[row])
    kids = torch.where(pres, C[sel], -1)
    t.child[row] = kids
    t.oid[row] = torch.where(pres, O[sel], -1)
    t.valid[row] = pres
    t.count[row] = n
    ok = kids >= 0
    t.parent[kids[ok].long()] = row
    t.pslot[kids[ok].long()] = slots[ok]


def _pop_free(t: TreeArrays) -> int:
    """Free-ring pop: the lowest free id (the ring is packed descending),
    the one the host's ``alloc`` picks.  The popped slot becomes -1 and
    ``n_nodes`` rises to cover the id."""
    top = max(int(t.free_head) - 1, 0)
    n2 = int(t.free_list[top])
    t.free_list[top] = -1
    t.free_head.sub_(1)
    t.n_nodes.clamp_(min=n2 + 1)
    return n2


def _push_free(t: TreeArrays, f: int):
    """Free-ring push of node id ``f`` at its descending-sorted position,
    not on top: the ring stays ``packed_free_list(alive)``, so a later pop
    allocates what the host would (DESIGN.md §12).  As in the reference,
    everything from that position on, the tail beyond ``free_head``
    included, moves up one slot."""
    fh = int(t.free_head)
    pos = int((t.free_list[:fh] > f).sum())
    t.free_list[pos + 1:] = t.free_list[pos:-1].clone()
    t.free_list[pos] = f
    t.free_head.add_(1)


def _split_row(t: TreeArrays, op: int, x, oid: int, blocked: bool):
    """One overflow insert resolved on the tree's device: the body of
    ``apply_splits``, bitwise to the host's ``insert_with_split``.

    The row re-descends the live tree (earlier rows of the pass may have
    made room) and appends when its leaf has room; otherwise it runs the
    multi-level split: mM_RAD promotion with minmax_split's tie order and
    member order, the lowest free id from the ring, the parent entry
    replaced and the second promoted entry appended, or the parent's
    entries spliced with it as the next level's pending set, or a new root.
    Only a near-empty ring (``free_head < height + 1``: the host would grow
    the node table) blocks the row, and with it every later overflow row of
    the pass, to keep log order.  Returns (status, blocked)."""
    cap = t.capacity
    if op != OP_INSERT:
        return ST_NOP, blocked
    if blocked:
        return ST_OVERFLOW, True
    pn, ps, leaf = _descend_path(t, x)
    cnt = int(t.count[leaf])
    if cnt < cap:
        # the host's re-check branch: append_entry + fold_up
        parent = int(t.parent[leaf])
        if parent >= 0:
            pvec = t.vecs[parent, max(int(t.pslot[leaf]), 0)]
            pd = _metric_eval(t.metric, x, pvec)
        else:
            pd = 0.0
        t.vecs[leaf, cnt] = x
        # explicit 0.0: a leaf in an ex-internal freed slot can carry a
        # stale nonzero radius beyond its count, and the host writes zero
        t.radius[leaf, cnt] = 0.0
        t.pdist[leaf, cnt] = pd
        t.oid[leaf, cnt] = oid
        t.valid[leaf, cnt] = True
        t.count[leaf] += 1
        _refresh_path_radii(t, pn, ps)
        return ST_SPLIT, False
    # worst case allocations: one split per level and a new root
    if int(t.free_head) < int(t.height) + 1:
        return ST_OVERFLOW, True

    # the pending set: the leaf's stored rows and the new entry.  R copies
    # the stored radius row, stale nonzeros included (the host's write_node
    # permutes them)
    V = torch.cat([t.vecs[leaf], x[None, :]])
    R = torch.cat([t.radius[leaf], t.radius.new_zeros(1)])
    C = torch.cat([t.child[leaf], t.child.new_full((1,), -1)])
    O = torch.cat([t.oid[leaf], t.oid.new_full((1,), oid)])
    pend_leaf, cur = True, leaf
    ms = min_side_for(cap + 1, cap, t.min_fill)
    every = torch.ones(cap + 1, dtype=torch.bool, device=t.device)
    while True:
        D = _metric_eval(t.metric, V[:, None, :], V[None, :, :])
        Radd = torch.zeros_like(R) if pend_leaf else R
        (pi, pj, sel_i, sel_j, pres_i, pres_j, n_i, n_j, r_i,
         r_j) = _promote_and_partition(t, D, Radd, every, cap + 1, ms,
                                       max_moves=ms)
        parent = int(t.parent[cur])         # read before any pointer write
        pslot_c = max(int(t.pslot[cur]), 0)
        n2 = _pop_free(t)
        _write_half(t, cur, V, R, C, O, _at(D, pi), sel_i, pres_i, n_i)
        _write_half(t, n2, V, R, C, O, _at(D, pj), sel_j, pres_j, n_j)
        t.alive[n2] = True
        t.is_leaf[n2] = pend_leaf
        vi, vj = _at(V, pi), _at(V, pj)

        if parent < 0:
            # a new root (the host's alloc + two append_entry calls: slots
            # 0/1 written, vecs/radius/pdist beyond them stay stale)
            nr = _pop_free(t)
            t.vecs[nr, 0] = vi
            t.radius[nr, 0] = r_i
            t.pdist[nr, 0] = 0.0
            t.vecs[nr, 1] = vj
            t.radius[nr, 1] = r_j
            t.pdist[nr, 1] = 0.0
            t.child[nr] = torch.tensor([cur, n2] + [-1] * (cap - 2),
                                       dtype=torch.int32, device=t.device)
            t.oid[nr] = -1
            t.valid[nr] = False
            t.valid[nr, :2] = True
            t.count[nr] = 2
            t.is_leaf[nr] = False
            t.alive[nr] = True
            t.parent[nr] = -1
            t.pslot[nr] = -1
            t.parent[cur] = t.parent[n2] = nr
            t.pslot[cur] = 0
            t.pslot[n2] = 1
            t.root.fill_(nr)
            t.height.add_(1)
            # promoted radii are exact: nothing to fold
            return ST_SPLIT, False

        # replace the entry pointing at cur with promoted i (the splice
        # below must see this write)
        gp = int(t.parent[parent])
        if gp >= 0:
            gv = t.vecs[gp, max(int(t.pslot[parent]), 0)]
            pd_i = _metric_eval(t.metric, vi, gv)
            pd_j = _metric_eval(t.metric, vj, gv)
        else:
            pd_i = pd_j = 0.0
        t.vecs[parent, pslot_c] = vi
        t.radius[parent, pslot_c] = r_i
        t.pdist[parent, pslot_c] = pd_i
        t.child[parent, pslot_c] = cur
        ap = int(t.count[parent])
        if ap < cap:
            # the parent has room: append promoted j, then fold from cur
            t.vecs[parent, ap] = vj
            t.radius[parent, ap] = r_j
            t.pdist[parent, ap] = pd_j
            t.child[parent, ap] = n2
            t.oid[parent, ap] = -1
            t.valid[parent, ap] = True
            t.count[parent] += 1
            t.parent[n2] = parent
            t.pslot[n2] = ap
            _refresh_path_radii(t, *path_to_root(t, cur))
            return ST_SPLIT, False
        # the parent is full: its (post-replacement) entries + promoted j
        # are the next pending set; n2's parent pointer is set by the next
        # level's _write_half, as on the host
        V = torch.cat([t.vecs[parent], vj[None, :]])
        R = torch.cat([t.radius[parent], r_j.reshape(1)])
        C = torch.cat([t.child[parent], t.child.new_full((1,), n2)])
        O = torch.cat([t.oid[parent], t.oid.new_full((1,), -1)])
        pend_leaf, cur = False, parent


def apply_splits(tree: TreeArrays, ops, xs, oids):
    """The device split pass over a compacted batch of overflow inserts, in
    place.  ops/xs/oids: [K] rows that ``apply_mutations`` reported
    ST_OVERFLOW (pads: OP_NOP / oid -1), in log order.  Returns (tree,
    statuses [K] int32): ST_SPLIT where the pass absorbed the row,
    ST_OVERFLOW from the first row that a near-empty free ring blocks on
    (and for every later insert row), ST_NOP for pads."""
    ops_h = np.asarray(torch.as_tensor(ops).cpu(), np.int64).reshape(-1)
    oids_h = np.asarray(torch.as_tensor(oids).cpu(), np.int64).reshape(-1)
    xs = torch.as_tensor(xs, dtype=torch.float32, device=tree.device)
    status = np.zeros(len(ops_h), np.int32)
    blocked = False
    for i, op in enumerate(ops_h.tolist()):
        status[i], blocked = _split_row(tree, op, xs[i], int(oids_h[i]),
                                        blocked)
    return tree, torch.from_numpy(status).to(tree.device)


# The reference's fixed dispatch width of the split pass (one jit entry per
# tree geometry).  The port's passes have nothing to compile: only the
# forest's split front is cut in these widths (stream/pipeline.py).
SPLIT_CHUNK = 8


def split_chunks(n: int):
    """Fixed-width cover of ``n`` rows (the last chunk padded by the
    caller)."""
    return [SPLIT_CHUNK] * ((n + SPLIT_CHUNK - 1) // SPLIT_CHUNK)


def _rows_where(statuses, ops, status: int, op: int) -> np.ndarray:
    statuses = np.asarray(statuses)
    ops = np.asarray(torch.as_tensor(ops).cpu()).reshape(-1)
    return np.nonzero((statuses == status) & (ops == op))[0]


def resolve_overflows(tree: TreeArrays, ops, xs, oids, statuses):
    """The batch's ST_OVERFLOW insert rows, compacted in log order, through
    the device split pass.  statuses: [B] on the host.  Returns (tree,
    statuses, n_resolved) with resolved rows re-marked ST_SPLIT.  One pass
    over the compacted rows gives what the reference's chunked dispatch
    gives: once a row blocks, the rest stay ST_OVERFLOW, in log order, for
    the host plane."""
    idx = _rows_where(statuses, ops, ST_OVERFLOW, OP_INSERT)
    out = np.array(statuses, np.int32, copy=True)
    if not len(idx):
        return tree, out, 0
    xs = torch.as_tensor(xs, dtype=torch.float32, device=tree.device)
    oids_h = np.asarray(torch.as_tensor(oids).cpu(), np.int32).reshape(-1)
    rows = torch.from_numpy(idx).to(tree.device)
    _, st = apply_splits(tree, np.full(len(idx), OP_INSERT, np.int32),
                         xs[rows], oids_h[idx])
    st = st.cpu().numpy()
    out[idx[st == ST_SPLIT]] = ST_SPLIT
    return tree, out, int((st == ST_SPLIT).sum())


def _remove_entry(t: TreeArrays, node: int, s: int):
    """The host's ``remove_entry``: swap-remove slot ``s`` of ``node`` (the
    last entry fills the hole and a swapped internal child's pslot is
    re-aimed), clear the tail slot, decrement the count; the write order
    handles ``s == last``."""
    last = max(int(t.count[node]) - 1, 0)
    for f in ("vecs", "radius", "pdist", "child", "oid"):
        a = getattr(t, f)
        a[node, s] = a[node, last].clone()
    c_sw = int(t.child[node, last])
    if s != last and not bool(t.is_leaf[node]) and c_sw >= 0:
        t.pslot[c_sw] = s
    t.valid[node, last] = False
    t.child[node, last] = -1
    t.oid[node, last] = -1
    t.count[node] -= 1


def _free_node(t: TreeArrays, node: int):
    """The host's ``free``: alive/valid cleared, count zeroed, parent/pslot
    detached; vecs/radius/pdist/child/oid stay stale, as the host leaves
    them.  Then the sorted free-ring push."""
    t.alive[node] = False
    t.valid[node] = False
    t.count[node] = 0
    t.parent[node] = -1
    t.pslot[node] = -1
    _push_free(t, node)


def _merge_row(t: TreeArrays, op: int, oid: int) -> int:
    """One underflow delete resolved on the tree's device: the body of
    ``apply_merges``, bitwise to the host's ``delete_with_merge``.

    The object is located again on the live tree (earlier rows may have
    moved it across nodes), first hit in row-major order, and
    swap-removed.  While the node underflows: the nearest sibling entry by
    routing-object distance (first minimum, self excluded), then either a
    merge into it (total fits: cur's entries appended in slot order, cur
    freed onto the ring, the parent entry removed, the sibling entry's
    radius refolded) or a redistribution (the union re-split by
    minmax_split's rules across the same two nodes, both parent entries
    rewritten).  Then the radius fold from the last node up and the
    collapse of single-entry internal roots.  Merges only free nodes, so a
    row never blocks.  Returns the status."""
    cap = t.capacity
    if op != OP_DELETE:
        return ST_NOP
    if oid < 0:                     # the pad sentinel never matches
        return ST_NOTFOUND
    hit = ((t.oid == oid) & t.valid).reshape(-1)
    flat = int(torch.argmax(hit.to(torch.uint8)))   # first hit
    if not bool(hit[flat]):
        return ST_NOTFOUND
    leaf, slot = divmod(flat, cap)
    _remove_entry(t, leaf, slot)
    slots = torch.arange(cap, dtype=torch.int32, device=t.device)
    cur = leaf
    while cur != int(t.root) and int(t.count[cur]) < t.min_fill:
        p = int(t.parent[cur])
        islot = max(int(t.pslot[cur]), 0)
        m = int(t.count[p])
        d = _metric_eval(t.metric, t.vecs[p, islot][None, :], t.vecs[p])
        d = torch.where((slots < m) & (slots != islot), d, _INF)
        j = int(torch.argmin(d))
        sib = max(int(t.child[p, j]), 0)
        cm = int(t.count[cur])
        ns = int(t.count[sib])
        total = ns + cm
        if total <= cap:
            # merge: cur's entries appended to sib in slot order
            pd_m = _metric_eval(t.metric, t.vecs[cur], t.vecs[p, j][None, :])
            for f, src in (("vecs", t.vecs[cur]), ("radius", t.radius[cur]),
                           ("pdist", pd_m), ("child", t.child[cur]),
                           ("oid", t.oid[cur])):
                getattr(t, f)[sib, ns:total] = src[:cm].clone()
            t.valid[sib, ns:total] = True
            t.count[sib] += cm
            kids = t.child[cur, :cm]
            ok = kids >= 0
            t.parent[kids[ok].long()] = sib
            t.pslot[kids[ok].long()] = ns + slots[:cm][ok]
            _free_node(t, cur)
            _remove_entry(t, p, islot)
            # removing islot may have moved entry j: re-read sib's pslot
            jj = max(int(t.pslot[sib]), 0)
            contrib = t.pdist[sib] + torch.where(t.is_leaf[sib], 0.0,
                                                 t.radius[sib])
            t.radius[p, jj] = torch.where(t.valid[sib], contrib, -_INF).amax()
        else:
            # redistribute: re-split the union (sib's entries first, then
            # cur's) across the same two nodes, read before any write
            M = 2 * cap
            ks = torch.arange(M, device=t.device)
            in_sib = ks < ns
            src_row = torch.where(in_sib, sib, cur)
            src_slot = torch.where(in_sib, ks, ks - ns).clamp(0, cap - 1)
            V = t.vecs[src_row, src_slot]
            R = t.radius[src_row, src_slot]
            C = t.child[src_row, src_slot]
            O = t.oid[src_row, src_slot]
            D = _metric_eval(t.metric, V[:, None, :], V[None, :, :])
            Radd = torch.zeros_like(R) if bool(t.is_leaf[cur]) else R
            # min_side_for with the member count of this union
            min_side = max(2, max(min(t.min_fill, total // 2), total - cap))
            (pi, pj, sel_i, sel_j, pres_i, pres_j, n_i, n_j, r_i,
             r_j) = _promote_and_partition(t, D, Radd, ks < total, total,
                                           min_side, max_moves=cap)
            _write_half(t, sib, V, R, C, O, _at(D, pi), sel_i, pres_i, n_i)
            _write_half(t, cur, V, R, C, O, _at(D, pj), sel_j, pres_j, n_j)
            vi, vj = _at(V, pi), _at(V, pj)
            gp = int(t.parent[p])
            if gp >= 0:
                gv = t.vecs[gp, max(int(t.pslot[p]), 0)]
                pd_i = _metric_eval(t.metric, vi, gv)
                pd_j = _metric_eval(t.metric, vj, gv)
            else:
                pd_i = pd_j = 0.0
            for s_, v, r, pd, c in ((j, vi, r_i, pd_i, sib),
                                    (islot, vj, r_j, pd_j, cur)):
                t.vecs[p, s_] = v
                t.radius[p, s_] = r
                t.pdist[p, s_] = pd
                t.child[p, s_] = c
                t.parent[c] = p
                t.pslot[c] = s_
        cur = p
    _refresh_path_radii(t, *path_to_root(t, cur))
    # root collapse, several levels after a deep cascade
    while True:
        old = int(t.root)
        if bool(t.is_leaf[old]) or int(t.count[old]) != 1:
            break
        newr = int(t.child[old, 0])
        t.root.fill_(newr)
        t.height.sub_(1)
        t.parent[newr] = -1
        t.pslot[newr] = -1
        _free_node(t, old)
    return ST_MERGE


def apply_merges(tree: TreeArrays, ops, oids):
    """The device merge pass over a compacted batch of underflow deletes,
    in place.  ops/oids: [K] rows that ``apply_mutations`` reported
    ST_UNDERFLOW (pads: OP_NOP / oid -1), in log order; the target is
    located by id alone, as the host's ``delete_with_merge`` does.  Returns
    (tree, statuses [K] int32): ST_MERGE for resolved rows, ST_NOTFOUND for
    targets that are gone, ST_NOP for pads.  No row ever blocks."""
    ops_h = np.asarray(torch.as_tensor(ops).cpu(), np.int64).reshape(-1)
    oids_h = np.asarray(torch.as_tensor(oids).cpu(), np.int64).reshape(-1)
    status = np.array([_merge_row(tree, op, int(o))
                       for op, o in zip(ops_h.tolist(), oids_h.tolist())],
                      np.int32).reshape(-1)
    return tree, torch.from_numpy(status).to(tree.device)


# The reference's two dispatch widths of the merge pass (two jit entries
# per geometry); as for SPLIT_CHUNK, only the forest's merge front is cut
# in these widths.
MERGE_CHUNK = 8
MERGE_CHUNK_MAX = 64


def merge_chunks(n: int):
    """Dispatch-width cover of ``n`` rows (each chunk padded by the
    caller): full MERGE_CHUNK_MAX chunks, then one more MAX chunk when the
    rest would take more than two small ones, else small chunks."""
    out = []
    while n >= MERGE_CHUNK_MAX:
        out.append(MERGE_CHUNK_MAX)
        n -= MERGE_CHUNK_MAX
    if n > 2 * MERGE_CHUNK:
        out.append(MERGE_CHUNK_MAX)
        n = 0
    while n > 0:
        out.append(MERGE_CHUNK)
        n -= MERGE_CHUNK
    return out


def resolve_underflows(tree: TreeArrays, ops, oids, statuses):
    """The batch's ST_UNDERFLOW delete rows, compacted in log order,
    through the device merge pass.  statuses: [B] on the host.  Returns
    (tree, statuses, n_resolved) with resolved rows re-marked ST_MERGE.
    Call it only once no ST_OVERFLOW row is left: the host plane resolves
    every overflow before any underflow, and the passes keep its order."""
    idx = _rows_where(statuses, ops, ST_UNDERFLOW, OP_DELETE)
    out = np.array(statuses, np.int32, copy=True)
    if not len(idx):
        return tree, out, 0
    oids_h = np.asarray(torch.as_tensor(oids).cpu(), np.int32).reshape(-1)
    _, st = apply_merges(tree, np.full(len(idx), OP_DELETE, np.int32),
                         oids_h[idx])
    out[idx] = st.cpu().numpy()
    return tree, out, len(idx)


# --------------------------------------------------------------------------
# Free-ring headroom (node-table growth off the hot path)
# --------------------------------------------------------------------------
def needs_headroom(tree: TreeArrays, *, frac: float = 1 / 16) -> bool:
    """True when the free ring is low enough that a batch could block the
    split pass.  The watermark is ``frac`` of the node table, floored at
    MAX_HEIGHT + 1 (the most one overflow row can allocate), so growth
    comes before any row can block.  Reads one scalar."""
    wm = max(MAX_HEIGHT + 1, int(tree.max_nodes * frac))
    return int(tree.free_head) < wm


def grow_tree(tree: TreeArrays, *, factor: int = 2) -> TreeArrays:
    """A new tree with ``factor * max_nodes`` node rows (the shapes change,
    so this one returns a new tree): the new rows are dead, laid out as the
    host's ``_grow`` lays them out (child/oid/parent/pslot -1, is_leaf
    True), and the free ring is recomputed.  The new ids are the highest,
    so they join the descending ring at the bottom and no allocation
    decision before growth changes.  The tables are padded on the tree's
    device."""
    if factor < 2:
        raise ValueError(f"factor must be >= 2, got {factor}")
    N = tree.max_nodes
    fields = {}
    for name in NODE_TABLE_FIELDS:
        if name == "free_list":
            continue
        a = getattr(tree, name)
        fill = (-1 if name in ("child", "oid", "parent", "pslot")
                else 1 if name == "is_leaf" else 0)
        pad = torch.full((N * (factor - 1),) + a.shape[1:], fill,
                         dtype=a.dtype, device=a.device)
        fields[name] = torch.cat([a, pad])
    dead = torch.nonzero(~fields["alive"]).reshape(-1).flip(0)
    free_list = torch.full((N * factor,), -1, dtype=torch.int32,
                           device=tree.device)
    free_list[:dead.shape[0]] = dead.to(torch.int32)
    free_head = torch.tensor(dead.shape[0], dtype=torch.int32,
                             device=tree.device)
    return dataclasses.replace(
        tree, **fields, free_list=free_list, free_head=free_head,
        root=tree.root.clone(), n_nodes=tree.n_nodes.clone(),
        height=tree.height.clone(), max_nodes=N * factor)
