"""SMTreeEngine: the front door to the PyTorch SM-tree.

Port of ``repro/core/engine.py``.  Data plane (the tree's device, the card
by default): bulk-built tree + batched knn/range_search + insert/delete
fast paths (core/smtree.py).  Control plane (host, numpy): node splits,
merges and re-splits — the amortised-rare structure edits — on a mutable
numpy view of the same arrays, sharing core/split.py's policy; ``to_tree``
moves the arrays back to the tree's device.

Engine-level invariants (``validate``):
  * SM radius invariant: r(entry) == max over child entries (pdist [+ r])
  * balance: all leaves at equal depth; parent/pslot pointers consistent
  * capacity/min-fill bounds away from the root
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.metric import make_metric
from repro_torch.core.smtree import (TreeArrays, bulk_build, delete_fast,
                                     empty_tree, insert_fast, knn,
                                     packed_free_list, range_search,
                                     tree_from_numpy)
from repro_torch.core.split import SPLIT_POLICIES, min_side_for

_HOST_FIELDS = ("vecs", "radius", "pdist", "child", "oid", "valid", "count",
                "is_leaf", "alive", "parent", "pslot")


class _HostView:
    """Mutable numpy mirror of TreeArrays for structure edits."""

    def __init__(self, t: TreeArrays):
        self.t = t
        for f in _HOST_FIELDS:
            # a copy: host edits must not write through to the tree
            setattr(self, f, getattr(t, f).cpu().numpy().copy())
        self.root = int(t.root)
        self.n_nodes = int(t.n_nodes)
        self.height = int(t.height)
        self.cap = t.capacity
        self.min_fill = t.min_fill
        self.metric = make_metric(t.metric, None)
        self.split = SPLIT_POLICIES["minmax"]

    # ---- storage management ------------------------------------------------
    def alloc(self, is_leaf: bool) -> int:
        free = np.nonzero(~self.alive)[0]
        if len(free) == 0:
            self._grow()
            free = np.nonzero(~self.alive)[0]
        i = int(free[0])
        self.alive[i] = True
        self.is_leaf[i] = is_leaf
        self.count[i] = 0
        self.valid[i] = False
        self.child[i] = -1
        self.oid[i] = -1
        self.parent[i] = -1
        self.pslot[i] = -1
        self.n_nodes = max(self.n_nodes, i + 1)
        return i

    def free(self, i: int):
        self.alive[i] = False
        self.valid[i] = False
        self.count[i] = 0
        self.parent[i] = -1
        self.pslot[i] = -1

    def _grow(self):
        N = len(self.count)
        for f in _HOST_FIELDS:
            a = getattr(self, f)
            pad = np.zeros((N,) + a.shape[1:], a.dtype)
            if f in ("child", "oid", "parent", "pslot"):
                pad -= 1
            if f == "is_leaf":
                pad |= True
            setattr(self, f, np.concatenate([a, pad], axis=0))

    # ---- helpers -------------------------------------------------------------
    def entries(self, n: int):
        m = int(self.count[n])
        return (self.vecs[n, :m].copy(), self.radius[n, :m].copy(),
                self.child[n, :m].copy(), self.oid[n, :m].copy())

    def write_node(self, n: int, vecs, radius, pdist, child, oid):
        m = len(oid)
        assert m <= self.cap
        self.vecs[n, :m] = vecs
        self.radius[n, :m] = radius
        self.pdist[n, :m] = pdist
        self.child[n, :m] = child
        self.oid[n, :m] = oid
        self.valid[n] = False
        self.valid[n, :m] = True
        self.child[n, m:] = -1
        self.oid[n, m:] = -1
        self.count[n] = m
        if not self.is_leaf[n]:
            for s, c in enumerate(child):
                self.parent[c] = n
                self.pslot[c] = s

    def routing_vec_of(self, n: int) -> Optional[np.ndarray]:
        """Reference value of the entry pointing at node n (None at root)."""
        p = int(self.parent[n])
        if p < 0:
            return None
        return self.vecs[p, int(self.pslot[n])]

    def fold_radius(self, n: int) -> float:
        """SM invariant value for the entry pointing at node n."""
        m = int(self.count[n])
        if m == 0:
            return 0.0
        contrib = self.pdist[n, :m] + (0.0 if self.is_leaf[n]
                                       else self.radius[n, :m])
        return float(contrib.max())

    def fold_up(self, n: int):
        """Recompute radii along the parent chain from node n to the root."""
        while True:
            p = int(self.parent[n])
            if p < 0:
                return
            self.radius[p, int(self.pslot[n])] = self.fold_radius(n)
            n = p

    def remove_entry(self, n: int, s: int):
        """Swap-remove slot s of node n, fixing the swapped child's pslot."""
        m = int(self.count[n]) - 1
        if s != m:
            for f in ("vecs", "radius", "pdist", "child", "oid"):
                getattr(self, f)[n, s] = getattr(self, f)[n, m]
            if not self.is_leaf[n]:
                c = int(self.child[n, s])
                self.pslot[c] = s
        self.valid[n, m] = False
        self.child[n, m] = -1
        self.oid[n, m] = -1
        self.count[n] = m

    def append_entry(self, n: int, vec, radius, pdist, child, oid) -> int:
        s = int(self.count[n])
        assert s < self.cap
        self.vecs[n, s] = vec
        self.radius[n, s] = radius
        self.pdist[n, s] = pdist
        self.child[n, s] = child
        self.oid[n, s] = oid
        self.valid[n, s] = True
        self.count[n] = s + 1
        if child >= 0:
            self.parent[child] = n
            self.pslot[child] = s
        return s

    # ---- split-insert (overflow path) ---------------------------------------
    def insert_with_split(self, x: np.ndarray, obj_id: int):
        # descend (closest-entry choose-subtree)
        node = self.root
        while not self.is_leaf[node]:
            m = int(self.count[node])
            d = self.metric(x[None, :], self.vecs[node, :m])
            node = int(self.child[node, int(np.argmin(d))])
        if int(self.count[node]) < self.cap:
            # the leaf has room after all (a caller may escalate against a
            # stale overflow verdict): plain append + radius fold, never a
            # split of a non-full leaf
            pv = self.routing_vec_of(node)
            pd = 0.0 if pv is None else float(self.metric(x, pv))
            self.append_entry(node, x, 0.0, pd, -1, obj_id)
            self.fold_up(node)
            return
        # pending entry set at the current level
        vecs, radius, child, oid = self.entries(node)
        vecs = np.vstack([vecs, x[None, :]])
        radius = np.append(radius, 0.0)
        child = np.append(child, -1)
        oid = np.append(oid, obj_id)
        cur = node
        while True:
            is_leaf = bool(self.is_leaf[cur])
            D = np.asarray(self.metric(vecs[:, None, :], vecs[None, :, :]),
                           dtype=np.float64)
            min_side = min_side_for(len(oid), self.cap, self.min_fill)
            pi, pj, side_i, side_j, r_i, r_j = self.split(
                D, radius, is_leaf, min_side)
            parent = int(self.parent[cur])
            pslot = int(self.pslot[cur]) if parent >= 0 else -1
            n2 = self.alloc(is_leaf)
            # write both halves (cur reused for side_i)
            self.is_leaf[cur] = is_leaf
            self.write_node(cur, vecs[side_i], radius[side_i],
                            D[pi, side_i], child[side_i], oid[side_i])
            self.write_node(n2, vecs[side_j], radius[side_j],
                            D[pj, side_j], child[side_j], oid[side_j])
            prom = [(vecs[pi], r_i, cur), (vecs[pj], r_j, n2)]
            if parent < 0:
                # grow a new root
                nr = self.alloc(is_leaf=False)
                for v, r, c in prom:
                    self.append_entry(nr, v, r, 0.0, c, -1)
                self.root = nr
                self.height += 1
                return
            # replace the entry pointing at cur, append the second promoted
            pv = self.routing_vec_of(parent)
            for idx, (v, r, c) in enumerate(prom):
                pd = 0.0 if pv is None else float(self.metric(v, pv))
                if idx == 0:
                    self.vecs[parent, pslot] = v
                    self.radius[parent, pslot] = r
                    self.pdist[parent, pslot] = pd
                    self.child[parent, pslot] = c
                    self.parent[c] = parent
                    self.pslot[c] = pslot
                elif int(self.count[parent]) < self.cap:
                    self.append_entry(parent, v, r, pd, c, -1)
                else:
                    # parent overflows: splice the pending entry set and loop
                    e_vecs, e_rad, e_child, e_oid = self.entries(parent)
                    vecs = np.vstack([e_vecs, v[None, :]])
                    radius = np.append(e_rad, r)
                    child = np.append(e_child, c)
                    oid = np.append(e_oid, -1)
                    cur = parent
                    break
            else:
                self.fold_up(cur)   # exact radii upward from here
                return

    # ---- underflow-delete (merge path) --------------------------------------
    def delete_with_merge(self, x: np.ndarray, obj_id: int) -> bool:
        hits = np.nonzero((self.oid == obj_id) & self.valid)
        if len(hits[0]) == 0:
            return False
        leaf, slot = int(hits[0][0]), int(hits[1][0])
        self.remove_entry(leaf, slot)
        cur = leaf
        while (cur != self.root and int(self.count[cur]) < self.min_fill):
            parent = int(self.parent[cur])
            islot = int(self.pslot[cur])
            # nearest sibling entry by routing-object distance
            m = int(self.count[parent])
            d = np.asarray(self.metric(self.vecs[parent, islot][None, :],
                                       self.vecs[parent, :m]), np.float64)
            d[islot] = np.inf
            j = int(np.argmin(d))
            sib = int(self.child[parent, j])
            total = int(self.count[sib]) + int(self.count[cur])
            if total <= self.cap:
                # merge cur's entries into sib
                sv = self.vecs[parent, j]
                cm = int(self.count[cur])
                for kk in range(cm):
                    pd = float(self.metric(self.vecs[cur, kk], sv))
                    self.append_entry(sib, self.vecs[cur, kk],
                                      self.radius[cur, kk], pd,
                                      int(self.child[cur, kk]),
                                      int(self.oid[cur, kk]))
                self.free(cur)
                self.remove_entry(parent, islot)
                # islot removal may have moved entry j
                jj = int(self.pslot[sib])
                self.radius[parent, jj] = self.fold_radius(sib)
            else:
                # re-split the union across cur and sib
                sv_, sr_, sc_, so_ = self.entries(sib)
                cv_, cr_, cc_, co_ = self.entries(cur)
                vecs = np.vstack([sv_, cv_])
                radius = np.concatenate([sr_, cr_])
                child = np.concatenate([sc_, cc_])
                oid = np.concatenate([so_, co_])
                is_leaf = bool(self.is_leaf[cur])
                D = np.asarray(self.metric(vecs[:, None, :], vecs[None, :, :]),
                               dtype=np.float64)
                min_side = min_side_for(len(oid), self.cap, self.min_fill)
                pi, pj, side_i, side_j, r_i, r_j = self.split(
                    D, radius, is_leaf, min_side)
                self.write_node(sib, vecs[side_i], radius[side_i],
                                D[pi, side_i], child[side_i], oid[side_i])
                self.write_node(cur, vecs[side_j], radius[side_j],
                                D[pj, side_j], child[side_j], oid[side_j])
                pv = self.routing_vec_of(parent)
                for (v, r, c, s_) in ((vecs[pi], r_i, sib, j),
                                      (vecs[pj], r_j, cur, islot)):
                    pd = 0.0 if pv is None else float(self.metric(v, pv))
                    self.vecs[parent, s_] = v
                    self.radius[parent, s_] = r
                    self.pdist[parent, s_] = pd
                    self.child[parent, s_] = c
                    self.parent[c] = parent
                    self.pslot[c] = s_
            cur = parent
        self.fold_up(cur)
        # root collapse
        while (not self.is_leaf[self.root]) and int(self.count[self.root]) == 1:
            old = self.root
            self.root = int(self.child[old, 0])
            self.parent[self.root] = -1
            self.pslot[self.root] = -1
            self.free(old)
            self.height -= 1
        return True

    # ---- back to the device ----------------------------------------------------
    def to_tree(self) -> TreeArrays:
        # the free ring is recomputed wholesale from the alive mask: host
        # allocs/frees (and _grow resizes) invalidate the packed layout
        free_list, free_head = packed_free_list(self.alive)
        arrays = {f: getattr(self, f) for f in _HOST_FIELDS}
        arrays.update(root=np.int32(self.root), n_nodes=np.int32(self.n_nodes),
                      height=np.int32(self.height), free_list=free_list,
                      free_head=free_head)
        meta = dict(capacity=self.t.capacity, dim=self.t.dim,
                    metric=self.t.metric, max_nodes=len(self.count),
                    min_fill=self.t.min_fill)
        return tree_from_numpy(arrays, meta, self.t.device)


class SMTreeEngine:
    """High-level API over the PyTorch SM-tree.  ``build``/``empty`` take a
    ``device`` (None = the card; it raises without one — pass
    ``device="cpu"`` to run on the CPU); every later call runs on the
    tree's device."""

    def __init__(self, tree: TreeArrays):
        self.tree = tree

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, X, ids=None, *, device=None, **kw) -> "SMTreeEngine":
        return cls(bulk_build(np.asarray(X), ids, device=device, **kw))

    @classmethod
    def empty(cls, *, device=None, **kw) -> "SMTreeEngine":
        return cls(empty_tree(device=device, **kw))

    # -- queries -----------------------------------------------------------------
    def knn(self, queries, k: int = 1, **kw):
        return knn(self.tree, queries, k=k, **kw)

    def range_search(self, queries, radius, **kw):
        return range_search(self.tree, queries, radius, **kw)

    # -- updates ------------------------------------------------------------------
    def insert(self, x, obj_id: int):
        x = np.asarray(x, np.float32)
        tree, fits, _leaf = insert_fast(self.tree, x, int(obj_id))
        if fits:
            self.tree = tree
            return
        hv = _HostView(self.tree)
        hv.insert_with_split(x, int(obj_id))
        self.tree = hv.to_tree()

    def delete(self, x, obj_id: int) -> bool:
        x = np.asarray(x, np.float32)
        tree, found, underflow, _leaf = delete_fast(self.tree, x, int(obj_id))
        if not found:
            return False
        if not underflow:
            self.tree = tree
            return True
        hv = _HostView(self.tree)
        ok = hv.delete_with_merge(x, int(obj_id))
        self.tree = hv.to_tree()
        return ok

    # -- validation -----------------------------------------------------------------
    def validate(self):
        """Structural + SM-invariant checks (host-side, exhaustive)."""
        t = _HostView(self.tree)
        mfn = t.metric
        leaf_depths = set()

        def rec(n: int, depth: int, pv):
            assert t.alive[n], f"dead node {n} reachable"
            m = int(t.count[n])
            assert (t.valid[n, :m].all() and not t.valid[n, m:].any()), \
                f"valid/count mismatch at {n}"
            assert m <= t.cap
            if n != t.root:
                assert m >= t.min_fill, f"underflown node {n}: {m}"
            if t.is_leaf[n]:
                leaf_depths.add(depth)
            if pv is not None:
                pd = np.asarray(mfn(t.vecs[n, :m], pv[None, :]))
                np.testing.assert_allclose(pd, t.pdist[n, :m], atol=1e-4,
                                           err_msg=f"stale pdist at node {n}")
            if not t.is_leaf[n]:
                for s in range(m):
                    c = int(t.child[n, s])
                    assert t.parent[c] == n and t.pslot[c] == s, \
                        f"parent pointer broken at {c}"
                    want = t.fold_radius(c)
                    np.testing.assert_allclose(
                        t.radius[n, s], want, atol=1e-4,
                        err_msg=f"SM invariant broken at node {n} slot {s}")
                    rec(c, depth + 1, t.vecs[n, s])

        rec(t.root, 0, None)
        assert len(leaf_depths) <= 1, f"unbalanced: {leaf_depths}"
        return True

    @property
    def n_objects(self) -> int:
        return self.tree.n_objects
