"""Serving-grade write pipelines: WAL ▸ batcher ▸ epochs ▸ snapshots.

Port of ``repro/stream/pipeline.py``.  Two orchestrators over the stream
primitives:

  * ``StreamingEngine``  — one SM-tree (the kNN-LM datastore case): every
    mutation batch is framed into the WAL *before* it is applied (write-
    ahead), applied through the conflict-free-cohort batcher, and the
    resulting tree version is published as the next epoch for concurrent
    readers.
  * ``StreamingForest``  — a sharded SM-forest: rows are routed to their
    owner shard (round-robin hash for new ids, ownership map — maintained
    across rebalances — for deletes) and applied by one of two planes,
    with background ``maintenance()`` firing the rebalancer when delete
    skew builds up.

The forest's ``maintenance()`` runs in one of two rebalance modes:
``stop_world`` (the one-shot ``rebalance_shards`` rebuild, kept as the
baseline and the replay path for old WALs) and ``incremental`` (a
deterministic ``MigrationPlan`` executed one bounded step per call — each
step a delete-on-donor / insert-on-receiver cohort behind one epoch
publish, DESIGN.md §16).

Both support ``snapshot()`` (atomic checkpoint carrying the tree geometry
and the WAL high-water mark, in the reference's on-disk format) and
``restore()`` = snapshot + WAL tail replay.  Replay routes every record
back through the identical code paths, so the restored state is **bitwise
identical** to the straight-line run, even after a crash between
migration steps, and a log or snapshot written by either package restores
in the other.

The port's mutation paths write tensors in place.  No published version
is ever written again: the batcher copies a tree once per batch, and the
stacked plane copies the stack once per batch, before the first write.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import distributed as dist
from repro_torch.core import smtree
from repro_torch.core.smtree import (OP_DELETE, OP_INSERT, TreeArrays,
                                     empty_tree)
from repro_torch.serve.frontend import pinned_knn
from repro_torch.stream.batcher import (BatchResult, MutationBatcher,
                                        check_oids, cut_cohorts,
                                        escalate_rows)
from repro_torch.stream.epoch import EpochManager
from repro_torch.stream.rebalance import (MigrationPlan, collect_stats,
                                          live_objects, needs_rebalance,
                                          plan_migration, rebalance_shards)
from repro_torch.stream.wal import (KIND_BATCH, KIND_MIGRATION_PLAN,
                                    KIND_MIGRATION_STEP, KIND_REBALANCE,
                                    WriteAheadLog)

__all__ = ["StreamingEngine", "StreamingForest"]

_ESCALATED = (smtree.ST_OVERFLOW, smtree.ST_UNDERFLOW)


def _mutation_log(xs, oids, op: int):
    xs = np.asarray(xs, np.float32)
    oids = np.asarray(oids, np.int32)
    return np.full(len(oids), op, np.int32), xs, oids


def _count_batch(res: BatchResult, n_rows: int) -> None:
    if obs.enabled():
        obs.counter("stream.batches_total").inc()
        obs.counter("stream.rows_total").inc(n_rows)
        obs.counter("stream.escalated_rows_total").inc(res.n_escalated)
        obs.counter("stream.device_splits_total").inc(res.n_split)
        obs.counter("stream.device_merges_total").inc(res.n_merge)


class StreamingEngine:
    """WAL-backed batched mutation pipeline over a single SM-tree.

    ``headroom_frac`` arms ahead-of-time free-ring growth: after each
    batch — an epoch-publish point, never mid-pass — the node table is
    doubled (``smtree.grow_tree``) whenever the free ring sits below
    ``max(MAX_HEIGHT + 1, headroom_frac * max_nodes)``, so ring
    exhaustion (the one split-path host escalation left) stops being a
    mid-batch event.  Growth is deterministic in the mutation sequence,
    which the WAL replay contract requires.  ``None`` disables it."""

    def __init__(self, tree: TreeArrays, *, wal: WriteAheadLog | None = None,
                 ckpt=None, max_batch: int = 4096, device_splits: bool = True,
                 device_merges: bool = True,
                 headroom_frac: float | None = 1 / 16):
        self.batcher = MutationBatcher(tree, max_batch=max_batch,
                                       device_splits=device_splits,
                                       device_merges=device_merges)
        self.wal = wal
        self.ckpt = ckpt          # dist.checkpoint.CheckpointManager
        self.headroom_frac = headroom_frac
        self.n_grows = 0
        self.epochs = EpochManager(tree)
        self._step = 0

    @property
    def tree(self) -> TreeArrays:
        return self.batcher.tree

    # -- mutations ---------------------------------------------------------
    def apply(self, ops, xs, oids, *, log: bool = True) -> BatchResult:
        """Apply one mutation batch; frames it into the WAL first so an
        acknowledged batch is always replayable.  Negative oids are rejected
        here — before the WAL append — so a bad batch can neither collide
        with the pad sentinel nor poison replay."""
        check_oids(oids)
        if log and self.wal is not None:
            with obs.span("mutation.wal_append", n=len(ops)):
                self.wal.append_batch(np.asarray(ops, np.int8), xs, oids)
        with obs.span("mutation.apply", n=len(ops)):
            res = self.batcher.apply(ops, xs, oids)
        if (self.headroom_frac is not None
                and smtree.needs_headroom(self.tree,
                                          frac=self.headroom_frac)):
            self.batcher.tree = smtree.grow_tree(self.tree)
            self.n_grows += 1
            obs.record_event("stream.tree_grow", n_grows=self.n_grows)
        with obs.span("mutation.publish"):
            self.epochs.publish(self.tree)
        _count_batch(res, len(ops))
        return res

    def insert_batch(self, xs, oids, **kw) -> BatchResult:
        ops, xs, oids = _mutation_log(xs, oids, OP_INSERT)
        return self.apply(ops, xs, oids, **kw)

    def delete_batch(self, xs, oids, **kw) -> BatchResult:
        ops, xs, oids = _mutation_log(xs, oids, OP_DELETE)
        return self.apply(ops, xs, oids, **kw)

    # -- snapshots ---------------------------------------------------------
    def _extra(self) -> dict:
        t = self.tree
        return {"kind": "smtree", "capacity": t.capacity, "dim": t.dim,
                "metric": t.metric, "max_nodes": t.max_nodes,
                "min_fill": t.min_fill,
                "wal_seq": (self.wal.next_seq - 1 if self.wal is not None
                            else -1)}

    def snapshot(self, step: int | None = None) -> int:
        """Checkpoint the current tree + WAL high-water mark."""
        if self.ckpt is None:
            raise ValueError("no CheckpointManager configured")
        step = self._step if step is None else step
        self.ckpt.save(step, {"tree": self.tree}, extra=self._extra())
        self._step = step + 1
        return step

    @classmethod
    def restore(cls, ckpt_dir: str, *, wal: WriteAheadLog | None = None,
                ckpt=None, device=None, **kw) -> "StreamingEngine":
        """Last snapshot + WAL tail replay (bitwise-deterministic), on
        ``device`` (None = the card)."""
        from repro_torch.dist.checkpoint import (read_manifest,
                                                 restore_checkpoint)
        manifest = read_manifest(ckpt_dir)
        extra = manifest["extra"]
        template = _tree_template(extra, device=device)
        state, _ = restore_checkpoint(ckpt_dir, {"tree": template},
                                      step=manifest["step"])
        eng = cls(state["tree"], wal=wal, ckpt=ckpt, **kw)
        eng._step = manifest["step"] + 1
        if wal is not None:
            for rec in wal.replay(after_seq=extra["wal_seq"]):
                if rec.kind == KIND_BATCH:
                    eng.apply(rec.ops.astype(np.int32), rec.xs, rec.oids,
                              log=False)
        return eng


def _tree_template(extra: dict, max_nodes: int | None = None, *,
                   device=None) -> TreeArrays:
    return empty_tree(dim=extra["dim"], capacity=extra["capacity"],
                      max_nodes=max_nodes or extra["max_nodes"],
                      metric=extra["metric"],
                      min_fill_frac=extra["min_fill"] / extra["capacity"],
                      device=device)


class StreamingForest:
    """WAL-backed batched mutation pipeline over a sharded SM-forest.

    Two control planes, as the reference's:

      * the host plane (``mesh=None``): shards are held as per-shard trees
        and mutated shard-at-a-time through per-shard batchers — each
        shard's cohorts run the batched scan + device split/merge passes;
      * the stacked plane (``mesh=`` the device the forest is stacked on,
        the port's one-card counterpart of the reference's mesh): the
        stacked forest (core/distributed.py) is the source of truth
        between rebuilds, and every WAL batch is applied as cut-cohorts →
        ``forest_apply_mutations`` → ``forest_apply_splits`` over the
        overflow rows in ``split_chunks`` widths → ``forest_apply_merges``
        over the underflow rows in ``merge_chunks`` widths.  Rows the
        fronts leave (a blocked split chain) go to the host plane for the
        shards that hold them (``_escalate_mesh``).

    Both planes produce bitwise-identical shards: the fronts run the same
    scan and passes per shard, and host escalation uses the same code in
    the same (overflow-first) order."""

    def __init__(self, trees: list[TreeArrays], *,
                 wal: WriteAheadLog | None = None, ckpt=None,
                 max_batch: int = 4096, max_skew: float = 1.5,
                 min_objects: int = 64, mesh=None,
                 device_splits: bool = True, device_merges: bool = True,
                 headroom_frac: float | None = 1 / 16,
                 rebalance_mode: str = "stop_world",
                 migration_step_objects: int = 64,
                 free_floor: float | None = None):
        if rebalance_mode not in ("stop_world", "incremental"):
            raise ValueError(f"unknown rebalance_mode {rebalance_mode!r} "
                             f"(expected 'stop_world' or 'incremental')")
        if mesh is not None:
            mesh = torch.empty(0, device=mesh).device    # "cuda" -> cuda:0
            on = {t.device for t in trees}
            if on != {mesh}:
                raise ValueError(f"the stacked plane on {mesh} needs every "
                                 f"shard there; they are on {sorted(map(str, on))}")
        self.rebalance_mode = rebalance_mode
        self.migration_step_objects = int(migration_step_objects)
        self.free_floor = free_floor
        self._migration: dict | None = None   # {"plan": MigrationPlan,
        #                                        "next": step index}
        self.n_migration_steps = 0
        self.objects_migrated = 0
        self.device_splits = device_splits
        self.device_merges = device_merges
        self.headroom_frac = headroom_frac
        self.n_grows = 0
        self.batchers = [MutationBatcher(t, max_batch=max_batch,
                                         device_splits=device_splits,
                                         device_merges=device_merges)
                         for t in trees]
        self.wal = wal
        self.ckpt = ckpt
        self.max_batch = int(max_batch)
        self.max_skew = max_skew
        self.min_objects = min_objects
        self.mesh = mesh
        # stacked plane: the stacked forest is the source of truth between
        # rebuilds; None = truth lives in the per-shard batchers
        self._stacked: TreeArrays | None = None
        self._shard_nodes = [t.max_nodes for t in trees]
        self.epochs = EpochManager(tuple(self.trees))
        self.owner: dict[int, int] = {}
        self._step = 0
        self.n_rebalances = 0
        self._rebuild_ownership()

    @property
    def trees(self) -> list[TreeArrays]:
        """The per-shard trees: the stacked forest's shards as views, each
        cut back to its own node-table size, or the batchers' trees."""
        if self._stacked is not None:
            return dist.unstack_forest(self._stacked,
                                       max_nodes=self._shard_nodes)
        return [b.tree for b in self.batchers]

    @property
    def n_shards(self) -> int:
        return len(self.batchers)

    @property
    def n_objects(self) -> int:
        return sum(t.n_objects for t in self.trees)

    def _rebuild_ownership(self) -> None:
        self.owner = {}
        for s, t in enumerate(self.trees):
            _, oids = live_objects(t)
            for o in oids:
                self.owner[int(o)] = s

    # -- routing -----------------------------------------------------------
    def route(self, ops, oids) -> np.ndarray:
        """Owner shard per row.  Deletes follow the ownership map (objects
        migrate under rebalancing); new inserts hash round-robin
        (oid mod S, matching ``build_forest``'s initial partition).  The
        map is scanned in log order so same-batch insert→delete pairs
        route consistently."""
        S = self.n_shards
        pending = dict(self.owner)
        out = np.empty(len(oids), np.int32)
        for i, (op, oid) in enumerate(zip(ops, oids)):
            o = int(oid)
            s = pending.get(o, o % S)
            out[i] = s
            if op == OP_INSERT:
                pending[o] = s
            elif op == OP_DELETE:
                pending.pop(o, None)
        return out

    # -- mutations ---------------------------------------------------------
    def apply(self, ops, xs, oids, *, log: bool = True) -> BatchResult:
        ops = np.asarray(ops, np.int32)
        xs = np.asarray(xs, np.float32)
        oids = np.asarray(oids, np.int32)
        check_oids(oids)
        if log and self.wal is not None:
            with obs.span("mutation.wal_append", n=len(ops)):
                self.wal.append_batch(ops.astype(np.int8), xs, oids)
        owner = self.route(ops, oids)
        with obs.span("mutation.apply", n=len(ops),
                      plane="stacked" if self.mesh is not None else "host"):
            if self.mesh is not None:
                res = self._apply_mesh(ops, xs, oids, owner)
            else:
                res = self._apply_host(ops, xs, oids, owner)
        applied = res.statuses == smtree.ST_APPLIED
        for i in np.nonzero(applied)[0]:
            if ops[i] == OP_INSERT:
                self.owner[int(oids[i])] = int(owner[i])
            else:
                self.owner.pop(int(oids[i]), None)
        self._ensure_headroom()
        with obs.span("mutation.publish"):
            self.epochs.publish(tuple(self.trees))
        _count_batch(res, len(ops))
        return res

    def _ensure_headroom(self) -> None:
        """Ahead-of-time free-ring growth (epoch-publish point): double any
        shard whose ring fell below the watermark, so the next batch's
        split pass cannot exhaust it mid-front.  Both planes read the same
        per-shard scalars and grow at the same points, which keeps them
        bitwise equal (and WAL replay deterministic)."""
        if self.headroom_frac is None:
            return
        needy = [s for s, t in enumerate(self.trees)
                 if smtree.needs_headroom(t, frac=self.headroom_frac)]
        if not needy:
            return
        trees = list(self.trees)
        for s in needy:
            trees[s] = smtree.grow_tree(trees[s])
        for b, t in zip(self.batchers, trees):
            b.tree = t
        # a grown shard has new shapes: drop the stacked form, the next
        # stacked batch restacks from the fresh shards
        self._stacked = None
        self._shard_nodes = [t.max_nodes for t in trees]
        self.n_grows += len(needy)

    def _apply_host(self, ops, xs, oids, owner) -> BatchResult:
        """Host plane: route rows to their shard's batcher.

        Cohorts are cut on the *global* log — the same boundaries the
        stacked plane's fronts use — so escalation interleaves with the
        scans at identical points in every shard's op sequence and the two
        planes stay bitwise-interchangeable.  Each shard with rows in the
        batch is copied once, before its first write."""
        for s in np.unique(owner).tolist():
            b = self.batchers[s]
            b.tree = smtree.clone_tree(b.tree)
        statuses = np.zeros(len(ops), np.int32)
        n_fast = n_esc = n_split = n_merge = 0
        cohorts = cut_cohorts(oids)
        for start, end in cohorts:
            for cs in range(start, end, self.max_batch):
                ce = min(cs + self.max_batch, end)
                for s in range(self.n_shards):
                    rows = cs + np.nonzero(owner[cs:ce] == s)[0]
                    if not len(rows):
                        continue
                    r = self.batchers[s].apply_in_place(
                        ops[rows], xs[rows], oids[rows])
                    statuses[rows] = r.statuses
                    n_fast += r.n_fast
                    n_esc += r.n_escalated
                    n_split += r.n_split
                    n_merge += r.n_merge
        return BatchResult(statuses, n_fast, n_esc, len(cohorts), n_split,
                           n_merge)

    def _working_stack(self) -> TreeArrays:
        """A stack this batch may write: a copy of the stacked forest (whose
        shards a published epoch may hold), or a fresh stack of the
        batchers' trees."""
        if self._stacked is None:
            return dist.stack_trees([b.tree for b in self.batchers])
        return smtree.clone_tree(self._stacked)

    def _apply_mesh(self, ops, xs, oids, owner) -> BatchResult:
        """Stacked plane: cut-cohorts → one ``forest_apply_mutations`` +
        the split front + the merge front per cohort; host escalation only
        for the residual rows (a blocked split chain — ring exhaustion —
        which ahead-of-time headroom growth makes a cold path).  The
        reference pads every front's batch with NOP rows to bound JAX's
        compile cache; the port does not (a NOP row changes nothing), but
        keeps the split ladder's chunk widths and its stop at the first
        blocked chunk, which decide the rows that reach the host plane."""
        forest = self._working_stack()
        statuses = np.zeros(len(ops), np.int32)
        n_fast = n_esc = n_split = n_merge = 0
        cohorts = cut_cohorts(oids)
        for start, end in cohorts:
            for cs in range(start, end, self.max_batch):
                ce = min(cs + self.max_batch, end)
                c_ops, c_xs, c_oids, c_owner = (ops[cs:ce], xs[cs:ce],
                                                oids[cs:ce], owner[cs:ce])
                forest, st = dist.forest_apply_mutations(
                    forest, c_ops, c_xs, c_oids, c_owner)
                st = st.cpu().numpy().copy()
                ovf = (np.nonzero((st == smtree.ST_OVERFLOW)
                                  & (c_ops == OP_INSERT))[0]
                       if self.device_splits else np.array([], np.int64))
                # the split ladder: stopping at the first still-blocked
                # chunk is conservative but bitwise-safe — the host plane
                # produces the identical split for any row the device
                # would have absorbed
                c0 = 0
                for w in smtree.split_chunks(len(ovf)):
                    chunk = ovf[c0:c0 + w]
                    c0 += w
                    forest, k_st = dist.forest_apply_splits(
                        forest, np.full(len(chunk), OP_INSERT, np.int32),
                        c_xs[chunk], c_oids[chunk], c_owner[chunk])
                    k_st = k_st.cpu().numpy()
                    st[chunk[k_st == smtree.ST_SPLIT]] = smtree.ST_SPLIT
                    if (k_st == smtree.ST_OVERFLOW).any():
                        break
                # the merge front: underflow rows resolve on the device only
                # once every overflow row has (the host plane resolves all
                # overflows before any underflow; a residual blocked split
                # must reach the host first to keep the structure-edit
                # order — and the bitwise tree — identical)
                unf = (np.nonzero((st == smtree.ST_UNDERFLOW)
                                  & (c_ops == OP_DELETE))[0]
                       if (self.device_merges
                           and not (st == smtree.ST_OVERFLOW).any())
                       else np.array([], np.int64))
                # merges never block, so every chunk is dispatched back to
                # back and the statuses are read once for the cohort
                c0 = 0
                pending = []
                for w in smtree.merge_chunks(len(unf)):
                    chunk = unf[c0:c0 + w]
                    c0 += w
                    forest, k_st = dist.forest_apply_merges(
                        forest, np.full(len(chunk), OP_DELETE, np.int32),
                        c_oids[chunk], c_owner[chunk])
                    pending.append((chunk, k_st))
                for chunk, k_st in pending:
                    st[chunk] = k_st.cpu().numpy()
                esc = np.isin(st, _ESCALATED)
                n_esc += int(esc.sum())
                n_split += int((st == smtree.ST_SPLIT).sum())
                n_merge += int((st == smtree.ST_MERGE).sum())
                n_fast += int((st == smtree.ST_APPLIED).sum())
                st[np.isin(st, (smtree.ST_SPLIT, smtree.ST_MERGE))] = \
                    smtree.ST_APPLIED
                if esc.any():
                    forest = self._escalate_mesh(forest, st, c_ops, c_xs,
                                                 c_oids, c_owner)
                statuses[cs:ce] = st
        self._stacked = forest
        return BatchResult(statuses, n_fast, n_esc, len(cohorts), n_split,
                           n_merge)

    def _escalate_mesh(self, forest, st, ops, xs, oids, owner):
        """Run the host plane on the shards that still hold unresolved
        rows, then restack (the rare path)."""
        trees = dist.unstack_forest(forest, max_nodes=self._shard_nodes)
        esc = np.nonzero(np.isin(st, _ESCALATED))[0]
        obs.record_event("stream.host_escalation", n_rows=int(len(esc)))
        for s in sorted(set(int(owner[i]) for i in esc)):
            rows = np.array([i for i in esc if owner[i] == s])
            sub = st[rows].copy()
            trees[s] = escalate_rows(trees[s], sub, ops[rows], xs[rows],
                                     oids[rows])
            st[rows] = sub
        self._shard_nodes = [t.max_nodes for t in trees]
        return dist.stack_trees(trees)

    def insert_batch(self, xs, oids, **kw) -> BatchResult:
        ops, xs, oids = _mutation_log(xs, oids, OP_INSERT)
        return self.apply(ops, xs, oids, **kw)

    def delete_batch(self, xs, oids, **kw) -> BatchResult:
        ops, xs, oids = _mutation_log(xs, oids, OP_DELETE)
        return self.apply(ops, xs, oids, **kw)

    # -- queries -----------------------------------------------------------
    def knn(self, queries, *, k: int = 8, max_frontier: int = 64):
        """Global kNN over a *pinned* epoch's shards: per-shard cohort
        descent + top-k merge (``serve.frontend.pinned_knn``).  Returns
        (dists [b, k], ids [b, k]) on the shards' device.  The pin
        (``EpochManager.reading``) keeps the version resident for the whole
        descent even if a writer publishes and retires epochs mid-query."""
        with self.epochs.reading() as trees:
            return pinned_knn(trees, queries, k=k, max_frontier=max_frontier)

    # -- maintenance -------------------------------------------------------
    def maintenance(self, *, log: bool = True) -> bool:
        """Bounded background repair; returns True when repair work ran.

        ``stop_world`` mode: detect skew and rebuild the touched shards in
        one pass.  ``incremental`` mode: when a migration plan is active,
        execute exactly one bounded step; otherwise consult the trigger
        and, when it fires, record the full deterministic plan in the WAL
        and execute its first step.  At most one step per call keeps the
        publish-time pause bounded regardless of how deep the skew is —
        callers invoke this once per mutation batch."""
        if self._migration is not None:
            self._migration_step(log=log)
            return True
        stats = collect_stats(self.trees)
        if obs.enabled():
            obs.gauge("rebalance.skew").set(stats.skew)
        if not needs_rebalance(stats, max_skew=self.max_skew,
                               min_objects=self.min_objects,
                               free_floor=self.free_floor):
            return False
        seed = (self.wal.next_seq if self.wal is not None
                else self.n_rebalances)
        if self.rebalance_mode == "stop_world":
            self._run_rebalance(int(seed), log=log)
            return True
        plan = plan_migration(self.trees, seed=int(seed),
                              step_objects=self.migration_step_objects)
        if not plan.steps:
            return False
        if log and self.wal is not None:
            self.wal.append_migration_plan(plan.to_params())
        self._install_migration(plan)
        self._migration_step(log=log)
        return True

    def _install_migration(self, plan: MigrationPlan, *,
                           next_step: int = 0) -> None:
        if self._migration is not None:
            raise ValueError("migration plan installed while another is "
                             "still active (corrupt WAL or snapshot?)")
        self._migration = {"plan": plan, "next": int(next_step)}
        obs.record_event("stream.migration_plan", seed=plan.seed,
                         steps=len(plan.steps), objects=plan.total)

    @property
    def migration_active(self) -> bool:
        return self._migration is not None

    def _extract(self, donor: int, oids: np.ndarray):
        """(vecs, found) on the host for ids on the donor shard.  The
        stacked plane gathers through the owner-routed front (only the
        [m, dim] vectors leave the stack); it sums the shards' masked rows
        as the reference's ``psum`` does, so a stored -0.0 comes back
        +0.0 there, as on the reference's mesh."""
        if self.mesh is not None:
            if self._stacked is None:
                self._stacked = dist.stack_trees(
                    [b.tree for b in self.batchers])
            vecs, found = dist.forest_extract_objects(
                self._stacked, oids, np.full(len(oids), donor, np.int32))
        else:
            vecs, found = smtree.extract_objects(self.batchers[donor].tree,
                                                 oids)
        return vecs.cpu().numpy(), found.cpu().numpy()

    def _migration_step(self, *, log: bool, expect: int | None = None) -> int:
        """Execute one bounded move from the active plan: extract the
        step's still-donor-owned objects and re-apply them as a normal
        delete-on-donor / insert-on-receiver conflict-free cohort pair
        through the standard apply path, then publish exactly one epoch.
        Readers pinned to the previous epoch see each object on the donor;
        the new epoch shows it on the receiver — never twice, never zero
        times.  Returns the number of objects re-homed."""
        mig = self._migration
        if mig is None:
            raise ValueError("no active migration plan")
        idx = mig["next"]
        if expect is not None and expect != idx:
            raise ValueError(
                f"WAL migration step {expect} does not match resume "
                f"position {idx} (truncated or reordered log)")
        plan: MigrationPlan = mig["plan"]
        step = plan.steps[idx]
        if log and self.wal is not None:
            self.wal.append_migration_step({"seed": plan.seed, "step": idx})
        t0 = time.perf_counter()
        # ids may have been deleted or re-routed since planning: move only
        # those still owned by the donor.  The owner map evolves
        # identically under replay, so the filter is deterministic.
        oids = np.asarray([o for o in step.oids
                           if self.owner.get(int(o)) == step.donor],
                          np.int32)
        moved = 0
        with obs.span("mutation.migration_step", n=len(oids), step=idx):
            n = 0
            if len(oids):
                vecs, found = self._extract(step.donor, oids)
                oids, vecs = oids[found], vecs[found]
                n = len(oids)
            if n:
                ops = np.concatenate([np.full(n, OP_DELETE, np.int32),
                                      np.full(n, OP_INSERT, np.int32)])
                xs = np.concatenate([vecs, vecs]).astype(np.float32)
                both = np.concatenate([oids, oids])
                owner = np.concatenate(
                    [np.full(n, step.donor, np.int32),
                     np.full(n, step.receiver, np.int32)])
                if self.mesh is not None:
                    res = self._apply_mesh(ops, xs, both, owner)
                else:
                    res = self._apply_host(ops, xs, both, owner)
                st = res.statuses
                for i, o in enumerate(oids):
                    o = int(o)
                    if st[n + i] == smtree.ST_APPLIED:
                        self.owner[o] = step.receiver
                        moved += 1
                    elif st[i] == smtree.ST_APPLIED:
                        # delete landed but the insert did not: the object
                        # is gone from both shards — drop it from the map
                        # rather than advertise a phantom owner
                        self.owner.pop(o, None)
        mig["next"] = idx + 1
        if mig["next"] >= len(plan.steps):
            self._migration = None
            self.n_rebalances += 1
            obs.record_event("stream.migration_done", seed=plan.seed,
                             steps=len(plan.steps))
        self._ensure_headroom()
        with obs.span("mutation.publish"):
            self.epochs.publish(tuple(self.trees),
                                meta={"migration": {"seed": plan.seed,
                                                    "step": idx}})
        self.n_migration_steps += 1
        self.objects_migrated += moved
        if obs.enabled():
            obs.counter("rebalance.migration_steps_total").inc()
            obs.counter("rebalance.objects_moved_total").inc(moved)
            obs.histogram("rebalance.step_pause_s").observe(
                time.perf_counter() - t0)
        return moved

    def apply_control(self, kind: str, params: dict) -> None:
        """Replay one WAL control record through the same state machine
        the live writer ran.  ``rebalance`` records re-run the stop-world
        rebuild with the recorded seed; ``migration_plan`` records
        re-install the recorded schedule; ``migration_step`` records
        re-execute the next bounded move, asserting the recorded index so
        a truncated or reordered log fails loudly instead of silently
        diverging."""
        if kind == KIND_REBALANCE:
            self._run_rebalance(int(params["seed"]), log=False)
        elif kind == KIND_MIGRATION_PLAN:
            self._install_migration(MigrationPlan.from_params(params))
        elif kind == KIND_MIGRATION_STEP:
            self._migration_step(log=False, expect=int(params["step"]))
        else:
            raise ValueError(f"unknown WAL control record kind {kind!r}")

    def _run_rebalance(self, seed: int, *, log: bool) -> None:
        obs.record_event("stream.rebalance", seed=seed)
        if log and self.wal is not None:
            self.wal.append_rebalance({"seed": seed})
        trees, moved, _ = rebalance_shards(self.trees, seed=seed)
        for b, t in zip(self.batchers, trees):
            b.tree = t
        # the rebuilt shards are new trees: drop the stacked form, the next
        # stacked batch restacks from them
        self._stacked = None
        self._shard_nodes = [t.max_nodes for t in trees]
        self.n_rebalances += 1
        self._rebuild_ownership()
        self._ensure_headroom()   # rebalance is a headroom-growth point too
        self.epochs.publish(tuple(self.trees))

    # -- snapshots ---------------------------------------------------------
    def stacked(self) -> TreeArrays:
        if self._stacked is not None:
            return self._stacked
        return dist.stack_trees(self.trees)

    def _extra(self) -> dict:
        proto = self.trees[0]
        mig = self._migration
        return {"kind": "smforest", "n_shards": self.n_shards,
                "capacity": proto.capacity, "dim": proto.dim,
                "metric": proto.metric, "min_fill": proto.min_fill,
                "shard_max_nodes": [t.max_nodes for t in self.trees],
                "n_rebalances": self.n_rebalances,
                "rebalance_mode": self.rebalance_mode,
                "n_migration_steps": self.n_migration_steps,
                # a snapshot taken mid-plan must carry the remaining
                # schedule: the WAL tail after this point holds only step
                # records, and replaying them needs the installed plan
                "migration": (None if mig is None else
                              {"params": mig["plan"].to_params(),
                               "next": int(mig["next"])}),
                "wal_seq": (self.wal.next_seq - 1 if self.wal is not None
                            else -1)}

    def snapshot(self, step: int | None = None) -> int:
        if self.ckpt is None:
            raise ValueError("no CheckpointManager configured")
        step = self._step if step is None else step
        self.ckpt.save(step, {"forest": self.stacked()},
                       extra=self._extra())
        self._step = step + 1
        return step

    @classmethod
    def restore(cls, ckpt_dir: str, *, wal: WriteAheadLog | None = None,
                ckpt=None, device=None, **kw) -> "StreamingForest":
        """Last snapshot + WAL tail replay on ``device`` (None = the card;
        bitwise-deterministic: batch records re-run the batcher, control
        records re-run through ``apply_control`` — a snapshot taken
        mid-migration re-installs the remaining plan from the manifest
        before the tail's step records resume it)."""
        from repro_torch.dist.checkpoint import (read_manifest,
                                                 restore_checkpoint)
        manifest = read_manifest(ckpt_dir)
        extra = manifest["extra"]
        shard_nodes = extra["shard_max_nodes"]
        template = dist.stack_trees([_tree_template(extra, max_nodes=m,
                                                    device=device)
                                     for m in shard_nodes])
        state, _ = restore_checkpoint(ckpt_dir, {"forest": template},
                                      step=manifest["step"])
        trees = dist.unstack_forest(state["forest"], max_nodes=shard_nodes)
        kw.setdefault("rebalance_mode",
                      extra.get("rebalance_mode", "stop_world"))
        forest = cls(trees, wal=wal, ckpt=ckpt, **kw)
        forest._step = manifest["step"] + 1
        forest.n_rebalances = extra.get("n_rebalances", 0)
        forest.n_migration_steps = extra.get("n_migration_steps", 0)
        mig = extra.get("migration")
        if mig:
            forest._install_migration(
                MigrationPlan.from_params(mig["params"]),
                next_step=int(mig["next"]))
        if wal is not None:
            for rec in wal.replay(after_seq=extra["wal_seq"]):
                if rec.kind == KIND_BATCH:
                    forest.apply(rec.ops.astype(np.int32), rec.xs, rec.oids,
                                 log=False)
                else:
                    forest.apply_control(rec.kind, rec.params or {})
        return forest
