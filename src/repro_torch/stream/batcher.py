"""Mutation batch executor: conflict-free cohorts through the batched apply.

Port of ``repro/stream/batcher.py``.  A mixed insert/delete log is cut into
**conflict-free cohorts** — maximal runs in which no object id repeats —
and each cohort goes through ``core.smtree.apply_mutations``: the batched
scan, then the device split and merge passes for the rows that overflow
or underflow.  Rows the passes cannot absorb (a near-empty free ring) are
**escalated** to the host plane (``escalate_rows``, the engine's
``_HostView`` split/merge code) after their cohort, in the reference's
order.  Within a cohort no id repeats, so the scan-then-escalate order is
invisible, and replaying the same batches through the same code gives
bitwise-identical trees (the WAL contract).

The port's ``apply_mutations`` writes the tree in place, where the
reference's returns a new immutable tree.  A published epoch
(stream/epoch.py) is a tree a reader may hold, so ``apply`` copies the tree
once per batch, before its first write, and writes only the copy: no
version a reader can hold is ever written again.

The reference pads each cohort with NOP rows to a power-of-two length to
bound JAX's compile cache.  The port has nothing to compile and a NOP row
changes nothing (its status is sliced off), so it does not pad.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import smtree
from repro_torch.core.smtree import (OP_DELETE, OP_INSERT, OP_NOP, ST_APPLIED,
                                     ST_MERGE, ST_NOTFOUND, ST_OVERFLOW,
                                     ST_SPLIT, ST_UNDERFLOW, TreeArrays)

__all__ = ["MutationBatcher", "BatchResult", "cut_cohorts", "check_oids",
           "escalate_rows", "OP_INSERT", "OP_DELETE", "OP_NOP"]


@dataclasses.dataclass
class BatchResult:
    statuses: np.ndarray      # [B] int32 — final per-row outcome (ST_*)
    n_fast: int               # rows absorbed by the batched scan
    n_escalated: int          # rows resolved by the host plane
    n_cohorts: int
    n_split: int = 0          # rows resolved by the device split pass
    n_merge: int = 0          # rows resolved by the device merge pass


def check_oids(oids: np.ndarray) -> None:
    """Boundary validation for mutation logs: negative object ids are
    reserved (-1 is the NOP pad sentinel of the forest's fronts, and the
    batched paths treat negatives as never-matching), so they must be
    rejected before a batch is WAL-framed or applied."""
    oids = np.asarray(oids)
    if len(oids) and int(oids.min()) < 0:
        raise ValueError(
            "negative object ids are reserved (NOP pad sentinel); got "
            f"min oid {int(oids.min())}")


def cut_cohorts(oids: np.ndarray) -> list[tuple[int, int]]:
    """Cut a log into maximal conflict-free [start, end) runs.

    A new cohort starts exactly when the incoming row's oid already appears
    in the current one, so within a cohort every id is unique and ops
    commute across the scan/escalation boundary."""
    cuts: list[tuple[int, int]] = []
    start = 0
    seen: set[int] = set()
    for i, oid in enumerate(oids):
        o = int(oid)
        if o in seen:
            cuts.append((start, i))
            start = i
            seen = set()
        seen.add(o)
    if len(oids) or not cuts:
        cuts.append((start, len(oids)))
    return cuts


def escalate_rows(tree: TreeArrays, statuses: np.ndarray, ops, xs,
                  oids) -> TreeArrays:
    """Resolve a cohort's ST_OVERFLOW and ST_UNDERFLOW rows on the host.

    One ``_HostView`` copy of the tree for the batch: the overflow rows
    first, then the underflow rows, each in log order (the device split
    pass resolves a log-order prefix of the overflow rows, so this order
    keeps the split order the same with the passes on or off; within a
    conflict-free cohort the two groups touch disjoint objects), then one
    ``to_tree``.  ``ops``/``xs``/``oids`` are the cohort's [B] rows on the
    host.  Mutates ``statuses`` in place (ST_APPLIED, or ST_NOTFOUND for a
    delete whose target is gone) and returns the new tree, or ``tree``
    itself when no row escalates."""
    rows = [i for i, s in enumerate(statuses) if s == ST_OVERFLOW]
    rows += [i for i, s in enumerate(statuses) if s == ST_UNDERFLOW]
    if not rows:
        return tree
    from repro_torch.core.engine import _HostView
    hv = _HostView(tree)
    for i in rows:
        if ops[i] == OP_INSERT:
            hv.insert_with_split(np.asarray(xs[i], np.float32), int(oids[i]))
            statuses[i] = ST_APPLIED
        else:
            ok = hv.delete_with_merge(np.asarray(xs[i], np.float32),
                                      int(oids[i]))
            statuses[i] = ST_APPLIED if ok else ST_NOTFOUND
    return hv.to_tree()


class MutationBatcher:
    """Applies mutation logs to one ``TreeArrays`` (a single tree or one
    forest shard).  Owns the tree between calls; read it back via
    ``.tree``.  ``apply`` never writes the tree it was given or the tree a
    previous ``apply`` left: it writes a copy taken once per batch.

    ``device_splits=False`` turns off the device split pass (every
    overflow escalates to the host) and ``device_merges=False`` the device
    merge pass (every underflow escalates): the references of the passes'
    transparency tests."""

    def __init__(self, tree: TreeArrays, *, max_batch: int = 4096,
                 device_splits: bool = True, device_merges: bool = True):
        self.tree = tree
        self.max_batch = int(max_batch)
        self.device_splits = device_splits
        self.device_merges = device_merges

    def apply(self, ops, xs, oids) -> BatchResult:
        """Apply a mutation log in order.  ops [B] (OP_*), xs [B, dim],
        oids [B] (non-negative).  Returns per-row statuses; the updated
        tree is ``self.tree``, a copy: the tree before the call is left as
        it was."""
        ops = np.asarray(ops, np.int32)
        xs = np.asarray(xs, np.float32)
        oids = np.asarray(oids, np.int32)
        if not ops.shape == oids.shape == xs.shape[:1]:
            raise ValueError(f"ops {ops.shape}, oids {oids.shape} and xs "
                             f"{xs.shape} disagree on the batch length")
        check_oids(oids)
        self.tree = smtree.clone_tree(self.tree)
        return self.apply_in_place(ops, xs, oids)

    def apply_in_place(self, ops, xs, oids) -> BatchResult:
        """``apply`` on ``self.tree`` itself, with no copy: for a caller
        that took the batch's copy already (the forest's host plane, which
        applies one batch as several cohorts per shard)."""
        statuses = np.zeros(len(ops), np.int32)
        n_fast = n_esc = n_split = n_merge = 0
        cohorts = cut_cohorts(oids)
        for start, end in cohorts:
            for cs in range(start, end, self.max_batch):
                ce = min(cs + self.max_batch, end)
                _, st = smtree.apply_mutations(
                    self.tree, ops[cs:ce], xs[cs:ce], oids[cs:ce],
                    splits=self.device_splits, merges=self.device_merges)
                st = st.cpu().numpy().copy()     # escalation writes it
                n_esc += int(np.isin(st, (ST_OVERFLOW, ST_UNDERFLOW)).sum())
                n_fast += int((st == ST_APPLIED).sum())
                n_split += int((st == ST_SPLIT).sum())
                n_merge += int((st == ST_MERGE).sum())
                st[np.isin(st, (ST_SPLIT, ST_MERGE))] = ST_APPLIED
                self.tree = escalate_rows(self.tree, st, ops[cs:ce],
                                          xs[cs:ce], oids[cs:ce])
                statuses[cs:ce] = st
        return BatchResult(statuses, n_fast, n_esc, len(cohorts), n_split,
                           n_merge)
