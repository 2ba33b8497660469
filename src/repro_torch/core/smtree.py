"""SM-tree engine in PyTorch: tree state, bulk build, cohort kNN/range
descent, and the Insert/Delete fast paths.

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

Insert/Delete and the batched mutation apply (``apply_mutations``) mutate
the tree's tensors in place (the reference returns a new pytree): the
engine replaces its tree after each operation anyway, and in place a
fast-path write touches a few rows instead of copying every array.
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from repro_torch.core.metric import get_metric, make_metric
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


def insert_fast(tree: TreeArrays, x, obj_id: int):
    """No-split insert, in place.  Returns (tree, fits, leaf_id).  When the
    leaf is full the tree is left unchanged with fits=False — the caller
    runs the host-side split path."""
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
    tree.vecs[leaf, slot] = x
    tree.radius[leaf, slot] = 0.0
    tree.pdist[leaf, slot] = pd
    tree.child[leaf, slot] = -1
    tree.oid[leaf, slot] = int(obj_id)
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


def _swap_remove(tree: TreeArrays, leaf: int, slot: int):
    """Remove entry ``slot`` of ``leaf``, in place: the leaf's last entry
    fills the hole, then the tail slot is cleared (this order handles
    slot == last), and the radii along the path to the root are refreshed."""
    last = int(tree.count[leaf]) - 1
    for f in ("vecs", "radius", "pdist", "child", "oid"):
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

_NOT_PORTED_ITEM_9 = ("the device split and merge passes (splits=True / "
                      "merges=True) are ROADMAP Queue 1 item 9, not ported "
                      "yet; pass splits=False, merges=False")


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
    _swap_remove(tree, leaf, slot)
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
    is ``insert_fast`` (whose leaf-slot radius 0.0 and child -1 are what
    leaf rows already hold), a delete row ``_delete_row``.

    ``splits``/``merges`` select the reference's device split and merge
    passes, which are not ported yet: either one raises
    ``NotImplementedError`` before any row is applied."""
    if splits or merges:
        raise NotImplementedError(_NOT_PORTED_ITEM_9)
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
            _, fits, _ = insert_fast(tree, xs[i], oids_h[i])
            status[i] = ST_APPLIED if fits else ST_OVERFLOW
        elif op == OP_DELETE:
            status[i] = _delete_row(tree, oids_h[i], leaf0[i], found0[i])
    return tree, torch.from_numpy(status).to(tree.device)


def move_objects(donor: TreeArrays, receiver: TreeArrays, oids, *,
                 splits: bool = True, merges: bool = True):
    """Re-home ``oids`` from ``donor`` into ``receiver``, both in place:
    (donor, receiver, moved [B] bool).  Insert before delete, so a failed
    row leaves an object visible twice across the pair, never zero times;
    ids absent from the donor, or whose insert or delete did not apply,
    report ``moved`` False.  ``splits``/``merges`` as in
    ``apply_mutations``: only False is ported."""
    if splits or merges:
        raise NotImplementedError(_NOT_PORTED_ITEM_9)
    oids = torch.as_tensor(oids, dtype=torch.int32, device=donor.device)
    vecs, found = extract_objects(donor, oids)
    ins_ops = torch.where(found, OP_INSERT, OP_NOP)
    receiver, st_i = apply_mutations(
        receiver, ins_ops, vecs, torch.where(found, oids, -1),
        splits=False, merges=False)
    placed = found & (st_i.to(donor.device) == ST_APPLIED)
    donor, st_d = apply_mutations(
        donor, torch.where(placed, OP_DELETE, OP_NOP), vecs,
        torch.where(placed, oids, -1), splits=False, merges=False)
    return donor, receiver, placed & (st_d == ST_APPLIED)
