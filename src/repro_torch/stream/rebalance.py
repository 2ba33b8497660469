"""Background forest rebalancing after skewed mutation streams.

A sharded SM-forest degrades under skew: a delete stream concentrated on a
few shards leaves them underfull (every query still pays their descent,
and their nodes sit near min-fill) while insert-heavy shards deepen.  This
module closes the ROADMAP item: it tracks per-shard live-object counts and
node fill-factor histograms, detects skew, and redistributes objects by
**rebuilding only the affected shards with ``bulk_build`` over donor
ranges** — donors shed their highest-id surplus, receivers absorb it, and
untouched shards keep their arrays bitwise intact.

Two repair strategies share the trigger and the donor/receiver pairing
math:

- **Stop-the-world** (``rebalance_shards``): rebuild every touched shard
  with ``bulk_build`` in one pass.  Simple, but the rebuild is a
  publish-time cliff (~hundreds of ms at bench scale) — kept as the
  baseline and as the replay path for WALs written before incremental
  mode existed.
- **Incremental** (``plan_migration`` → ``MigrationPlan``): emit a
  deterministic schedule of bounded steps (one donor, one receiver, at
  most ``step_objects`` ids each).  The streaming forest executes at most
  one step per mutation batch as a normal delete-on-donor /
  insert-on-receiver cohort behind the epoch mechanism, so skew drains
  continuously with no cliff (repro.stream.pipeline, DESIGN.md §16).

Everything here is deterministic given the input trees and a seed: the
decision to rebalance — and, in incremental mode, the full plan plus each
executed step — is recorded in the WAL (``append_rebalance`` /
``append_migration_plan`` / ``append_migration_step``) so a snapshot +
tail replay re-executes the identical repair at the identical point in
the mutation order (repro.stream.pipeline, DESIGN.md §10, §16).

Port of ``repro/stream/rebalance.py``.  The planner reads each shard's
tensors on the host (``live_objects``, ``collect_stats``: a whole-tree
copy to numpy per shard), and a stop-the-world rebuild moves the touched
shards' objects through numpy and ``bulk_build`` back onto the shards'
device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.smtree import TreeArrays, bulk_build, empty_tree

__all__ = ["ShardStats", "collect_stats", "needs_rebalance",
           "rebalance_shards", "live_objects", "GeometryMismatch",
           "check_geometry", "MigrationStep", "MigrationPlan",
           "plan_migration"]

_FILL_BINS = np.array([0.0, 0.25, 0.5, 0.75, 1.0 + 1e-9])


@dataclasses.dataclass
class ShardStats:
    live_counts: np.ndarray    # [S] live objects per shard
    fill_hist: np.ndarray      # [S, 4] alive-node fill-fraction histogram
    free_nodes: np.ndarray     # [S] unallocated node slots

    @property
    def total(self) -> int:
        return int(self.live_counts.sum())

    @property
    def skew(self) -> float:
        """Most-loaded vs least-loaded shard, add-one smoothed
        (1.0 = perfectly balanced).  max/min rather than max/mean: a
        single shard drained by a skewed delete stream barely moves the
        mean of S shards but collapses the min — exactly the case the
        rebalancer exists for."""
        if self.live_counts.size == 0:
            return 1.0
        return float((self.live_counts.max() + 1)
                     / (self.live_counts.min() + 1))


def live_objects(tree: TreeArrays) -> tuple[np.ndarray, np.ndarray]:
    """(vectors [m, dim], ids [m]) of every live object, in deterministic
    node-major order."""
    valid = tree.valid.cpu().numpy()
    mask = (valid & tree.is_leaf.cpu().numpy()[:, None]
            & tree.alive.cpu().numpy()[:, None])
    return tree.vecs.cpu().numpy()[mask], tree.oid.cpu().numpy()[mask]


def collect_stats(trees: list[TreeArrays]) -> ShardStats:
    counts, hists, free = [], [], []
    for t in trees:
        alive = t.alive.cpu().numpy()
        cnt = t.count.cpu().numpy()
        counts.append(t.n_objects)
        fills = cnt[alive] / t.capacity
        hists.append(np.histogram(fills, bins=_FILL_BINS)[0])
        free.append(int((~alive).sum()))
    return ShardStats(np.asarray(counts, np.int64),
                      np.stack(hists).astype(np.int64),
                      np.asarray(free, np.int64))


def needs_rebalance(stats: ShardStats, *, max_skew: float = 1.5,
                    min_objects: int = 64,
                    free_floor: float | None = None) -> bool:
    """Trigger policy: fire when the most loaded shard holds ``max_skew``×
    the least loaded one.  Tiny forests never trigger — rebuilding them
    costs more than the skew.

    With ``free_floor`` set, additionally fire on free-ring pressure: an
    over-target shard whose unallocated-node fraction has dropped below
    the floor is about to force a mid-batch host ``grow_tree`` escalation,
    and shedding its surplus (merges reclaim nodes as objects leave) is
    cheaper than growing its arrays.  Balanced-but-starved shards are not
    a rebalancing problem — migration cannot shed anything from a shard
    already at target, so those stay with the apply path's headroom
    growth."""
    if stats.total < min_objects:
        return False
    if stats.skew > max_skew:
        return True
    if free_floor is not None and stats.live_counts.size:
        alive = stats.fill_hist.sum(axis=1)
        frac = stats.free_nodes / np.maximum(alive + stats.free_nodes, 1)
        pressured = frac < free_floor
        over_target = stats.live_counts > _targets(stats.live_counts)
        if bool((pressured & over_target).any()):
            return True
    return False


class GeometryMismatch(ValueError):
    """Forest shards disagree on tree geometry (capacity / dim / metric /
    min-fill).  Moving objects between such shards — or rebuilding a
    drained one from shard 0's prototype — would silently manufacture a
    divergent shard, so redistribution refuses up front."""


def check_geometry(trees: list[TreeArrays]) -> None:
    """Assert donor/receiver geometry compatibility across the forest.

    Every redistribution path rebuilds or grows shards from shard 0's
    (capacity, dim, metric, min_fill) prototype; raise a typed error if
    any shard disagrees instead of building a divergent one."""
    if not trees:
        return
    p = trees[0]
    ref = (p.capacity, p.dim, p.metric, p.min_fill)
    for s, t in enumerate(trees[1:], 1):
        got = (t.capacity, t.dim, t.metric, t.min_fill)
        if got != ref:
            raise GeometryMismatch(
                f"shard {s} geometry (capacity, dim, metric, min_fill)="
                f"{got!r} differs from shard 0 {ref!r}; cross-shard object "
                f"moves would rebuild a divergent shard")


def _targets(counts: np.ndarray) -> np.ndarray:
    """Balanced per-shard targets: total split as evenly as integers allow
    (first ``total mod S`` shards take the extra object)."""
    S = len(counts)
    total = int(counts.sum())
    base = total // S
    t = np.full(S, base, np.int64)
    t[:total - base * S] += 1
    return t


def rebalance_shards(trees: list[TreeArrays], *, seed: int = 0,
                     ) -> tuple[list[TreeArrays], int, dict]:
    """Redistribute live objects toward balanced shard sizes.

    Donors (above target) shed their highest-id objects; the pooled
    surplus fills receivers (below target) in shard order.  Every affected
    shard is rebuilt with ``bulk_build`` over its new object set (seeded
    ``seed + shard``); unaffected shards are returned as-is (bitwise).
    Returns (trees, n_moved, params) where ``params`` round-trips through
    the WAL for deterministic replay."""
    check_geometry(trees)
    S = len(trees)
    per_shard = [live_objects(t) for t in trees]
    counts = np.asarray([len(oids) for _, oids in per_shard], np.int64)
    targets = _targets(counts)

    pool_vecs: list[np.ndarray] = []
    pool_oids: list[np.ndarray] = []
    keep: list[tuple[np.ndarray, np.ndarray]] = []
    touched = [False] * S
    for s in range(S):
        vecs, oids = per_shard[s]
        surplus = int(counts[s] - targets[s])
        if surplus > 0:
            order = np.argsort(oids, kind="stable")
            donate, retain = order[-surplus:], order[:-surplus]
            pool_vecs.append(vecs[donate])
            pool_oids.append(oids[donate])
            keep.append((vecs[retain], oids[retain]))
            touched[s] = True
        else:
            keep.append((vecs, oids))
    moved = int(sum(len(o) for o in pool_oids))
    if moved == 0:
        return trees, 0, {"seed": int(seed), "moved": 0}
    pv = np.concatenate(pool_vecs)
    po = np.concatenate(pool_oids)
    order = np.argsort(po, kind="stable")
    pv, po = pv[order], po[order]

    out: list[TreeArrays] = []
    cursor = 0
    proto = trees[0]
    for s in range(S):
        vecs, oids = keep[s]
        deficit = int(targets[s] - counts[s])
        if deficit > 0:
            vecs = np.concatenate([vecs, pv[cursor:cursor + deficit]])
            oids = np.concatenate([oids, po[cursor:cursor + deficit]])
            cursor += deficit
            touched[s] = True
        if not touched[s]:
            out.append(trees[s])
        elif len(oids) == 0:
            out.append(empty_tree(
                dim=proto.dim, capacity=proto.capacity,
                max_nodes=max(16, trees[s].max_nodes), metric=proto.metric,
                min_fill_frac=proto.min_fill / proto.capacity,
                device=trees[s].device))
        else:
            out.append(bulk_build(
                np.asarray(vecs, np.float32), ids=np.asarray(oids),
                capacity=proto.capacity, metric=proto.metric,
                min_fill_frac=proto.min_fill / proto.capacity,
                seed=int(seed) + s, device=trees[s].device))
    return out, moved, {"seed": int(seed), "moved": moved}


# --------------------------------------------------------------------------
# Incremental migration planning (DESIGN.md §16)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MigrationStep:
    """One bounded move: re-home ``oids`` from shard ``donor`` to shard
    ``receiver``.  A step is a single delete-on-donor / insert-on-receiver
    cohort, so executing it costs one normal apply dispatch + one epoch
    publish."""
    donor: int
    receiver: int
    oids: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class MigrationPlan:
    """Deterministic migration schedule.  The full plan (not just the
    seed) rides the WAL control record: replay — including resuming after
    a crash mid-plan — re-installs exactly this object→shard assignment
    even though the trees have mutated since planning time."""
    seed: int
    steps: tuple[MigrationStep, ...]

    @property
    def total(self) -> int:
        return sum(len(s.oids) for s in self.steps)

    def to_params(self) -> dict:
        return {"seed": int(self.seed),
                "steps": [[int(s.donor), int(s.receiver),
                           [int(o) for o in s.oids]] for s in self.steps]}

    @classmethod
    def from_params(cls, params: dict) -> "MigrationPlan":
        steps = tuple(MigrationStep(int(d), int(r),
                                    tuple(int(o) for o in oids))
                      for d, r, oids in params["steps"])
        return cls(int(params["seed"]), steps)


def plan_migration(trees: list[TreeArrays], *, seed: int = 0,
                   step_objects: int = 64) -> MigrationPlan:
    """Plan the same redistribution ``rebalance_shards`` would perform,
    as a schedule of bounded steps instead of a one-shot rebuild.

    The donor/receiver pairing is decision-for-decision the stop-the-world
    math: donors (above target) shed their highest-id surplus, the pooled
    surplus — stable-sorted by object id — fills receivers (below target)
    in shard order.  The assignments are then grouped by (donor, receiver)
    pair (pairs in first-appearance order, oid order preserved within a
    pair — donors interleave in the oid-sorted pool, so cutting on raw
    pair changes would degenerate to one-object steps) and each group is
    cut into steps of at most ``step_objects`` ids, so every step stays a
    bounded conflict-free two-shard cohort.  Deterministic given
    (trees, seed, step_objects)."""
    check_geometry(trees)
    S = len(trees)
    per_shard = [live_objects(t)[1] for t in trees]
    counts = np.asarray([len(oids) for oids in per_shard], np.int64)
    targets = _targets(counts)

    pool_oids: list[np.ndarray] = []
    pool_donor: list[np.ndarray] = []
    for s in range(S):
        surplus = int(counts[s] - targets[s])
        if surplus > 0:
            order = np.argsort(per_shard[s], kind="stable")
            donate = order[-surplus:]
            pool_oids.append(per_shard[s][donate])
            pool_donor.append(np.full(surplus, s, np.int64))
    if not pool_oids:
        return MigrationPlan(int(seed), ())
    po = np.concatenate(pool_oids)
    pd = np.concatenate(pool_donor)
    order = np.argsort(po, kind="stable")
    po, pd = po[order], pd[order]

    # receivers consume pool slices in shard order — identical to the
    # stop-the-world cursor walk (surpluses and deficits sum equal by
    # _targets construction, so the whole pool is assigned)
    pr = np.empty(len(po), np.int64)
    cursor = 0
    for s in range(S):
        deficit = int(targets[s] - counts[s])
        if deficit > 0:
            pr[cursor:cursor + deficit] = s
            cursor += deficit

    groups: dict[tuple[int, int], list[int]] = {}
    for oid, d, r in zip(po.tolist(), pd.tolist(), pr.tolist()):
        groups.setdefault((int(d), int(r)), []).append(int(oid))
    steps: list[MigrationStep] = []
    for (d, r), oids in groups.items():
        for c in range(0, len(oids), step_objects):
            steps.append(MigrationStep(d, r,
                                       tuple(oids[c:c + step_objects])))
    return MigrationPlan(int(seed), tuple(steps))
