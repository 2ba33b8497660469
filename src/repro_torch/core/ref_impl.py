"""Paper-exact reference implementation of the M-tree and SM-tree.

The port's own copy of ``repro/core/ref_impl.py`` (jax-free there too), on
the port's ``metric`` and ``split``.

This module is the *oracle* for everything else in the repo: it follows the
pseudocode of Sexton & Swinbank, "Symmetric M-tree" (CSR-04-2 / arXiv cs.DB
2010) line by line, plus the original M-tree (Ciaccia et al., VLDB'97) as the
baseline the paper compares against.  It is numpy-vectorised *per node* but
deliberately keeps the paper's sequential pointer-machine structure so that
page-hit (IO) counts reproduce the paper's Figures 5-10.

Corrections relative to the paper's pseudocode (see DESIGN.md §1):
  * Delete assigns the returned covering radius unconditionally (the printed
    pseudocode's ``if r > r(O_n)`` guard is an erratum copied from Insert —
    it would prevent radii from ever contracting).
  * Delete stops after the object is found (objects are stored once).
  * Root handling: root split grows the tree; an internal root left with a
    single entry is collapsed (its child becomes the new root).

Cost model: ``tree.ios`` counts node accesses (page hits) and
``tree.dist_calcs`` counts metric evaluations; queries reset both via
``tree.reset_counters()``.  Infinite buffer pool per query (the tree is a
tree: within one query each node is visited at most once anyway).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.metric import make_metric

__all__ = ["MTree", "SMTree", "Node", "TreeStats"]


# --------------------------------------------------------------------------
# Node storage: parallel arrays per node (vectorised distance evaluation).
# --------------------------------------------------------------------------
class Node:
    __slots__ = ("vecs", "radii", "pdists", "ids", "children", "is_leaf")

    def __init__(self, dim: int, is_leaf: bool):
        self.vecs = np.empty((0, dim), dtype=np.float32)
        self.radii = np.empty((0,), dtype=np.float64)      # 0.0 for leaf entries
        self.pdists = np.empty((0,), dtype=np.float64)     # d(entry, parent routing obj)
        self.ids = []                                       # leaf: object ids; internal: None
        self.children = []                                  # internal: child Nodes
        self.is_leaf = is_leaf

    def __len__(self) -> int:
        return self.vecs.shape[0]

    def add(self, vec, radius, pdist, obj_id=None, child=None):
        self.vecs = np.vstack([self.vecs, vec[None, :]])
        self.radii = np.append(self.radii, radius)
        self.pdists = np.append(self.pdists, pdist)
        self.ids.append(obj_id)
        self.children.append(child)

    def remove(self, idx: int):
        keep = np.arange(len(self)) != idx
        self.vecs = self.vecs[keep]
        self.radii = self.radii[keep]
        self.pdists = self.pdists[keep]
        del self.ids[idx]
        del self.children[idx]

    def set_all(self, vecs, radii, pdists, ids, children):
        self.vecs = np.asarray(vecs, dtype=np.float32).reshape(len(ids), -1)
        self.radii = np.asarray(radii, dtype=np.float64)
        self.pdists = np.asarray(pdists, dtype=np.float64)
        self.ids = list(ids)
        self.children = list(children)


@dataclass
class TreeStats:
    n_objects: int = 0
    n_nodes: int = 0
    n_leaves: int = 0
    height: int = 0
    occupancy: float = 0.0  # mean fill fraction over all nodes


# --------------------------------------------------------------------------
# Shared base: storage parameters, queries, split, validation.
# --------------------------------------------------------------------------
class _BaseTree:
    """Common machinery; Insert/Delete differ per subclass."""

    def __init__(self, dim: int = 20, *, capacity: int = 42,
                 min_fill_frac: float = 0.4, metric: str = "d_inf",
                 n_dims: Optional[int] = None, split_policy: str = "minmax"):
        if capacity < 4:
            raise ValueError("capacity must be >= 4")
        from repro_torch.core.split import SPLIT_POLICIES
        self.dim = dim
        self.capacity = capacity
        self.min_fill = max(1, int(np.ceil(min_fill_frac * capacity)))
        self.metric_name = metric
        self.n_dims = n_dims
        self.split_policy = SPLIT_POLICIES[split_policy]
        self._metric = make_metric(metric, n_dims)
        self.root = Node(dim, is_leaf=True)
        self.height = 1
        self.n_objects = 0
        self.ios = 0
        self.dist_calcs = 0

    # -- metric helpers (instrumented) ------------------------------------
    def _d(self, x: np.ndarray, y: np.ndarray) -> float:
        self.dist_calcs += 1
        return float(self._metric(x, y))

    def _d_many(self, q: np.ndarray, vecs: np.ndarray) -> np.ndarray:
        """Distances from q to each row of vecs."""
        if len(vecs) == 0:
            return np.empty((0,), dtype=np.float64)
        self.dist_calcs += len(vecs)
        return np.asarray(self._metric(q[None, :], vecs), dtype=np.float64)

    def reset_counters(self):
        self.ios = 0
        self.dist_calcs = 0

    # -- queries -----------------------------------------------------------
    def range_query(self, q: np.ndarray, radius: float) -> list[int]:
        """All object ids within ``radius`` of q (paper's Range query)."""
        q = np.asarray(q, dtype=np.float32)
        out: list[int] = []
        self._range(self.root, q, radius, None, out)
        return out

    def _range(self, node: Node, q, r_q, d_q_parent, out):
        self.ios += 1
        if len(node) == 0:
            return
        if node.is_leaf:
            if d_q_parent is None:
                cand = np.arange(len(node))
            else:  # parent-distance prefilter: saves distance computations
                cand = np.nonzero(np.abs(d_q_parent - node.pdists) <= r_q)[0]
            if len(cand):
                d = self._d_many(q, node.vecs[cand])
                for i, di in zip(cand, d):
                    if di <= r_q:
                        out.append(node.ids[i])
        else:
            if d_q_parent is None:
                cand = np.arange(len(node))
            else:
                cand = np.nonzero(np.abs(d_q_parent - node.pdists)
                                  <= r_q + node.radii)[0]
            if len(cand):
                d = self._d_many(q, node.vecs[cand])
                for i, di in zip(cand, d):
                    if di <= r_q + node.radii[i]:
                        self._range(node.children[i], q, r_q, di, out)

    def knn_query(self, q: np.ndarray, k: int) -> list[tuple[float, int]]:
        """k nearest neighbours, paper-faithful (§4.1): 'a search begins as a
        range query with infinite range and the search radius is contracted
        as objects within it are encountered' — i.e. depth-first descent with
        a dynamic radius, children visited in ascending d_min order.

        (``knn_query_bestfirst`` below is the Hjaltason–Samet optimal-IO
        variant — a beyond-paper optimisation; for q in the database it
        provably visits exactly the R-0 node set, collapsing the paper's
        Fig.5-vs-Fig.7 gap.  Benchmarked separately.)"""
        q = np.asarray(q, dtype=np.float32)
        best: list[tuple[float, int]] = []       # max-heap via negated dist
        state = {"r_q": np.inf}

        def visit(node: Node, d_parent):
            self.ios += 1
            if len(node) == 0:
                return
            r_q = state["r_q"]
            if node.is_leaf:
                if d_parent is None:
                    cand = np.arange(len(node))
                else:
                    cand = np.nonzero(np.abs(d_parent - node.pdists) <= r_q)[0]
                if len(cand):
                    d = self._d_many(q, node.vecs[cand])
                    for i, di in zip(cand, d):
                        if di <= state["r_q"]:
                            heapq.heappush(best, (-di, node.ids[i]))
                            if len(best) > k:
                                heapq.heappop(best)
                            if len(best) == k:
                                state["r_q"] = -best[0][0]
            else:
                if d_parent is None:
                    cand = np.arange(len(node))
                else:
                    cand = np.nonzero(np.abs(d_parent - node.pdists)
                                      <= r_q + node.radii)[0]
                if len(cand):
                    d = self._d_many(q, node.vecs[cand])
                    dmin = np.maximum(d - node.radii[cand], 0.0)
                    for o in np.argsort(dmin):
                        if dmin[o] <= state["r_q"]:   # re-check: radius shrinks
                            visit(node.children[cand[o]], d[o])

        visit(self.root, None)
        return sorted((-nd, oid) for nd, oid in best)

    def knn_query_bestfirst(self, q: np.ndarray, k: int) -> list[tuple[float, int]]:
        """Optimal-IO kNN (beyond paper): global best-first priority queue."""
        q = np.asarray(q, dtype=np.float32)
        # heap of (d_min(Q, subtree), counter, node, d(Q, routing) or None)
        cnt = itertools.count()
        pq: list = [(0.0, next(cnt), self.root, None)]
        best: list[tuple[float, int]] = []   # max-heap via negated distance
        r_q = np.inf
        while pq:
            d_min, _, node, d_parent = heapq.heappop(pq)
            if d_min > r_q:
                break  # nothing reachable can beat current kth distance
            self.ios += 1
            if len(node) == 0:
                continue
            if node.is_leaf:
                if d_parent is None:
                    cand = np.arange(len(node))
                else:
                    cand = np.nonzero(np.abs(d_parent - node.pdists) <= r_q)[0]
                if len(cand):
                    d = self._d_many(q, node.vecs[cand])
                    for i, di in zip(cand, d):
                        if di <= r_q:
                            heapq.heappush(best, (-di, node.ids[i]))
                            if len(best) > k:
                                heapq.heappop(best)
                            if len(best) == k:
                                r_q = -best[0][0]
            else:
                if d_parent is None:
                    cand = np.arange(len(node))
                else:
                    cand = np.nonzero(np.abs(d_parent - node.pdists)
                                      <= r_q + node.radii)[0]
                if len(cand):
                    d = self._d_many(q, node.vecs[cand])
                    for i, di in zip(cand, d):
                        dmin_child = max(di - node.radii[i], 0.0)
                        if dmin_child <= r_q:
                            heapq.heappush(
                                pq, (dmin_child, next(cnt), node.children[i], di))
        return sorted((-nd, oid) for nd, oid in best)

    # -- split: mM_RAD promotion + generalized-hyperplane distribution ----
    def _split(self, vecs, radii, ids, children, is_leaf):
        """Partition the overflown entry set into two nodes.

        Promotion: MinMax (mM_RAD) — try every pair of entries as promoted
        routing objects, pick the pair minimising the larger covering radius.
        Distribution: generalized hyperplane (each entry to the closer
        promoted object) followed by a minimum-fill rebalance.

        Returns (node1, vec1, r1), (node2, vec2, r2): two fresh nodes and
        their routing entries' reference values + covering radii.  Entry
        parent distances inside each node are set here; the *promoted*
        entries' own parent distances are the caller's job.
        """
        m = len(ids)
        vecs = np.asarray(vecs, dtype=np.float32).reshape(m, -1)
        radii = np.asarray(radii, dtype=np.float64)
        D = np.asarray(self._metric(vecs[:, None, :], vecs[None, :, :]),
                       dtype=np.float64)
        self.dist_calcs += m * m
        from repro_torch.core.split import min_side_for
        min_side = min_side_for(m, self.capacity, self.min_fill)
        pi, pj, side_i, side_j, r_i, r_j = self.split_policy(
            D, radii, is_leaf, min_side)

        def build(promoter, members, r):
            members = np.asarray(members)
            node = Node(self.dim, is_leaf)
            node.set_all(vecs[members], radii[members], D[promoter, members],
                         [ids[k] for k in members],
                         [children[k] for k in members])
            return node, vecs[promoter].copy(), float(r)

        n1 = build(pi, side_i, r_i)
        n2 = build(pj, side_j, r_j)
        return n1, n2

    # -- stats & validation -------------------------------------------------
    def stats(self) -> TreeStats:
        n_nodes = n_leaves = 0
        fill = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            n_nodes += 1
            fill.append(len(node) / self.capacity)
            if node.is_leaf:
                n_leaves += 1
            else:
                stack.extend(node.children)
        return TreeStats(self.n_objects, n_nodes, n_leaves, self.height,
                         float(np.mean(fill)) if fill else 0.0)

    def leaf_io_count(self) -> int:
        """IOs for a sequential scan of the leaf level (paper's horizontal
        'efficiency limit' lines in Figs. 5-8)."""
        return self.stats().n_leaves

    def all_objects(self) -> list[tuple[int, np.ndarray]]:
        out = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node.is_leaf:
                out.extend((node.ids[i], node.vecs[i]) for i in range(len(node)))
            else:
                stack.extend(node.children)
        return out

    def validate(self, *, check_sm_invariant: bool = False,
                 check_min_fill: bool = False, sm_exact: bool | None = None):
        """Structural invariants; raises AssertionError on violation.

        ``sm_exact`` — require r == max(pdist+r) over immediate children
        (the SM-tree's stated invariant); defaults to the tree's
        ``tighten_on_insert`` flag.  When False only the upper bound
        r >= max(pdist+r) is required (pseudocode-literal insert).
        """
        if sm_exact is None:
            sm_exact = getattr(self, "tighten_on_insert", True)
        leaf_depths = set()

        def rec(node: Node, depth: int, parent_vec):
            if node.is_leaf:
                leaf_depths.add(depth)
            assert len(node) <= self.capacity, "capacity overflow"
            if check_min_fill and node is not self.root:
                assert len(node) >= self.min_fill, (
                    f"underflown node: {len(node)} < {self.min_fill}")
            for i in range(len(node)):
                if parent_vec is not None:
                    pd = float(self._metric(node.vecs[i], parent_vec))
                    assert abs(pd - node.pdists[i]) < 1e-4, (
                        f"stale parentDistance {node.pdists[i]} vs {pd}")
            if not node.is_leaf:
                for i, child in enumerate(node.children):
                    assert child is not None
                    # coverage: every object in subtree within r of routing vec
                    objs = []
                    st = [child]
                    while st:
                        nd = st.pop()
                        if nd.is_leaf:
                            objs.extend(nd.vecs)
                        else:
                            st.extend(nd.children)
                    if objs:
                        dmax = float(np.max(self._metric(
                            node.vecs[i][None, :], np.asarray(objs))))
                        assert dmax <= node.radii[i] + 1e-4, (
                            f"covering radius violated: {dmax} > {node.radii[i]}")
                    if check_sm_invariant:
                        # r vs max(pdist + r_child) over immediate children
                        if len(child):
                            want = float(np.max(child.pdists + child.radii))
                            if sm_exact:
                                assert abs(want - node.radii[i]) < 1e-4, (
                                    f"SM invariant broken: r={node.radii[i]} "
                                    f"vs max(pdist+r)={want}")
                            else:
                                assert want <= node.radii[i] + 1e-4, (
                                    f"SM bound broken: r={node.radii[i]} "
                                    f"< max(pdist+r)={want}")
                    rec(child, depth + 1, node.vecs[i])

        rec(self.root, 0, None)
        assert len(leaf_depths) <= 1, f"unbalanced tree: leaf depths {leaf_depths}"

    # -- helpers for root growth/shrink ------------------------------------
    def _grow_root(self, split_result):
        (n1, v1, r1), (n2, v2, r2) = split_result
        new_root = Node(self.dim, is_leaf=False)
        new_root.add(v1, r1, 0.0, None, n1)
        new_root.add(v2, r2, 0.0, None, n2)
        self.root = new_root
        self.height += 1


# --------------------------------------------------------------------------
# M-tree (baseline; Ciaccia et al. '97): lazy top-down radius expansion.
# --------------------------------------------------------------------------
class MTree(_BaseTree):
    supports_delete = False

    def insert(self, vec: np.ndarray, obj_id: int):
        vec = np.asarray(vec, dtype=np.float32)
        res = self._insert(self.root, vec, obj_id, None)
        if res is not None:
            self._grow_root(res)
        self.n_objects += 1

    def _insert(self, node: Node, vec, obj_id, parent_vec):
        self.ios += 1
        if node.is_leaf:
            pd = self._d(vec, parent_vec) if parent_vec is not None else 0.0
            node.add(vec, 0.0, pd, obj_id, None)
            if len(node) > self.capacity:
                return self._split(node.vecs, node.radii, node.ids,
                                   node.children, True)
            return None
        # choose subtree: zero-expansion if possible (closest such), else
        # minimal expansion (then expand the radius top-down: the asymmetry).
        d = self._d_many(vec, node.vecs)
        inside = d <= node.radii
        if inside.any():
            i = int(np.where(inside, d, np.inf).argmin())
        else:
            i = int((d - node.radii).argmin())
            node.radii[i] = d[i]          # lazy top-down expansion
        res = self._insert(node.children[i], vec, obj_id, node.vecs[i])
        if res is not None:
            (n1, v1, r1), (n2, v2, r2) = res
            node.remove(i)
            pd1 = self._d(v1, parent_vec) if parent_vec is not None else 0.0
            pd2 = self._d(v2, parent_vec) if parent_vec is not None else 0.0
            node.add(v1, r1, pd1, None, n1)
            node.add(v2, r2, pd2, None, n2)
            if len(node) > self.capacity:
                return self._split(node.vecs, node.radii, node.ids,
                                   node.children, False)
        return None


# --------------------------------------------------------------------------
# SM-tree (the paper): bottom-up radius maintenance; symmetric insert/delete.
# --------------------------------------------------------------------------
class SMTree(_BaseTree):
    """SM-tree.

    ``tighten_on_insert`` (default True) assigns the radius returned by the
    recursive Insert unconditionally, maintaining the paper's *stated*
    invariant exactly: r(O_n) == max(pdist + r) over immediate children ("at
    the size they would be were they newly promoted from below", §3.1).  The
    printed pseudocode instead guards with ``if r > r(O_bestSubtree)``; after
    a split in the subtree the recomputed bound can legitimately *shrink*, so
    the literal pseudocode degrades the invariant to an upper bound.  Set
    ``tighten_on_insert=False`` for the pseudocode-literal behaviour (still
    correct, slightly looser radii).  See DESIGN.md §1.
    """
    supports_delete = True

    def __init__(self, *args, tighten_on_insert: bool = True, **kw):
        super().__init__(*args, **kw)
        self.tighten_on_insert = tighten_on_insert

    # ---- Insert (paper §3.1) ---------------------------------------------
    def insert(self, vec: np.ndarray, obj_id: int):
        vec = np.asarray(vec, dtype=np.float32)
        res = self._insert(self.root, vec, obj_id, None)
        if isinstance(res, tuple):
            self._grow_root(res)
        self.n_objects += 1

    def _insert(self, node: Node, vec, obj_id, parent_vec):
        """Returns new covering radius (float) or split result (tuple)."""
        self.ios += 1
        if node.is_leaf:
            pd = self._d(vec, parent_vec) if parent_vec is not None else 0.0
            node.add(vec, 0.0, pd, obj_id, None)
            if len(node) > self.capacity:
                return self._split(node.vecs, node.radii, node.ids,
                                   node.children, True)
            return float(node.pdists.max())
        # choose subtree: closest entry (paper §3.1 — radius expansion can no
        # longer be predicted during descent, so centre subtrees tightly)
        d = self._d_many(vec, node.vecs)
        i = int(d.argmin())
        res = self._insert(node.children[i], vec, obj_id, node.vecs[i])
        if isinstance(res, tuple):            # entries promoted from below
            (n1, v1, r1), (n2, v2, r2) = res
            node.remove(i)
            pd1 = self._d(v1, parent_vec) if parent_vec is not None else 0.0
            pd2 = self._d(v2, parent_vec) if parent_vec is not None else 0.0
            node.add(v1, r1, pd1, None, n1)
            node.add(v2, r2, pd2, None, n2)
            if len(node) > self.capacity:
                return self._split(node.vecs, node.radii, node.ids,
                                   node.children, False)
        else:                                  # (possibly expanded) radius
            if self.tighten_on_insert or res > node.radii[i]:
                node.radii[i] = res
        return float((node.pdists + node.radii).max())

    # ---- Delete (paper §3.2, with erratum fixes) ---------------------------
    def delete(self, vec: np.ndarray, obj_id: int) -> bool:
        """Delete object ``obj_id`` located at ``vec``; True if found."""
        vec = np.asarray(vec, dtype=np.float32)
        res = self._delete(self.root, vec, obj_id, None)
        if res is None:
            return False
        self.n_objects -= 1
        # root collapse: internal root with a single entry -> child is root
        while (not self.root.is_leaf) and len(self.root) == 1:
            self.root = self.root.children[0]
            self.root.pdists = np.zeros(len(self.root))  # root entries: no parent
            self.height -= 1
        # root entries have no parent routing object; normalise pdists
        return True

    def _delete(self, node: Node, vec, obj_id, parent_vec):
        """Returns None (not found), ('r', radius) or ('uf', node) where the
        node's entries are to be redistributed by the caller."""
        self.ios += 1
        if node.is_leaf:
            try:
                idx = next(i for i in range(len(node))
                           if node.ids[i] == obj_id)
            except StopIteration:
                return None
            node.remove(idx)
            if node is not self.root and len(node) < self.min_fill:
                return ("uf", node)
            return ("r", float(node.pdists.max()) if len(node) else 0.0)

        d = self._d_many(vec, node.vecs)
        order = np.argsort(d)                      # visit closest-first
        for i in order:
            i = int(i)
            if d[i] > node.radii[i]:
                continue                            # triangle-inequality prune
            res = self._delete(node.children[i], vec, obj_id, node.vecs[i])
            if res is None:
                continue                            # not in that subtree
            if res[0] == "r":
                node.radii[i] = res[1]              # UNCONDITIONAL (erratum fix)
            else:                                    # child underflow
                self._handle_underflow(node, i, res[1], parent_vec)
            if node is not self.root and len(node) < self.min_fill:
                return ("uf", node)
            if len(node):
                return ("r", float((node.pdists + node.radii).max()))
            return ("r", 0.0)
        return None

    def _handle_underflow(self, node: Node, i: int, child: Node, parent_vec):
        """Merge underflown child(i)'s entries into the nearest sibling's
        child, or re-split the union (paper §3.2)."""
        # nearest sibling entry O_NN (by distance between routing objects)
        d_sib = self._d_many(node.vecs[i], node.vecs)
        d_sib[i] = np.inf
        j = int(d_sib.argmin())
        sib = node.children[j]
        assert sib.is_leaf == child.is_leaf
        total = len(sib) + len(child)
        if total <= self.capacity:
            # merge child's entries into sibling
            for k in range(len(child)):
                pd = self._d(child.vecs[k], node.vecs[j])
                sib.add(child.vecs[k], child.radii[k], pd,
                        child.ids[k], child.children[k])
            node.remove(i)
            if sib.is_leaf:
                node.radii[j if j < i else j - 1] = float(sib.pdists.max())
            else:
                node.radii[j if j < i else j - 1] = float(
                    (sib.pdists + sib.radii).max())
        else:
            # re-split the union into two nodes
            vecs = np.vstack([sib.vecs, child.vecs])
            radii = np.concatenate([sib.radii, child.radii])
            ids = sib.ids + child.ids
            children = sib.children + child.children
            (n1, v1, r1), (n2, v2, r2) = self._split(
                vecs, radii, ids, children, sib.is_leaf)
            # remove higher index first to keep the other valid
            for k in sorted((i, j), reverse=True):
                node.remove(k)
            pd1 = self._d(v1, parent_vec) if parent_vec is not None else 0.0
            pd2 = self._d(v2, parent_vec) if parent_vec is not None else 0.0
            node.add(v1, r1, pd1, None, n1)
            node.add(v2, r2, pd2, None, n2)
