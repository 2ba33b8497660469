"""repro_torch.stream — the online-mutation subsystem (DESIGN.md §10), port
of ``repro/stream``:

  * ``batcher``   — conflict-free mutation cohorts through the batched
    apply and the device split/merge passes (the host plane,
    ``escalate_rows``, for the rows they leave); one copy of the tree per
    batch, so no published epoch is written again.
  * ``wal``       — append-only write-ahead log (segment rotation, strict
    JSON manifest, the reference's byte format).
  * ``epoch``     — epoch-based snapshot handoff: readers pin tree versions
    while the writer advances.
  * ``rebalance`` — skew detection + repair: stop-the-world shard rebuilds
    or deterministic ``MigrationPlan`` schedules, one bounded step per
    mutation batch (DESIGN.md §16).
  * ``pipeline``  — ``StreamingEngine`` / ``StreamingForest`` with snapshot
    + WAL-tail restore (bitwise-deterministic, across the two packages).
  * ``replica``   — followers that tail the leader's WAL and verify their
    epochs by digest exchange.
  * ``transport`` — WAL shipping over a socket (``WalShipServer``,
    ``WalShipClient``, ``ShippedReplica``); a mirror segment is sealed only
    at the leader's length.
  * ``lease``     — leases with monotonic fencing tokens, the WAL's
    ``FenceGuard`` and ``promote`` (failover).
  * ``faults``    — the seeded fault injector of the chaos drills.
"""
from repro_torch.stream.batcher import (MutationBatcher, cut_cohorts,
                                        escalate_rows)
from repro_torch.stream.epoch import EpochManager
from repro_torch.stream.faults import NO_FAULTS, FaultInjector, FaultPlan
from repro_torch.stream.lease import (FenceGuard, Lease, LeaseLost, LeaseStore,
                                      Promotion, promote)
from repro_torch.stream.pipeline import StreamingEngine, StreamingForest
from repro_torch.stream.rebalance import (GeometryMismatch, MigrationPlan,
                                          MigrationStep, check_geometry,
                                          collect_stats, needs_rebalance,
                                          plan_migration, rebalance_shards)
from repro_torch.stream.replica import (DigestMismatch, Replica,
                                        ledger_digest, tree_digest)
from repro_torch.stream.transport import (ShippedReplica, ShipStall,
                                          TransportError, WalShipClient,
                                          WalShipServer)
from repro_torch.stream.wal import (FencedOut, WalCursor, WalTailStall,
                                    WriteAheadLog, iter_wal, tail_wal)

__all__ = ["MutationBatcher", "cut_cohorts", "escalate_rows", "EpochManager",
           "StreamingEngine", "StreamingForest", "GeometryMismatch",
           "MigrationPlan", "MigrationStep", "check_geometry", "collect_stats",
           "needs_rebalance", "plan_migration", "rebalance_shards",
           "DigestMismatch", "Replica", "ledger_digest", "tree_digest",
           "FencedOut", "WalCursor", "WalTailStall", "WriteAheadLog",
           "iter_wal", "tail_wal", "FaultInjector", "FaultPlan", "NO_FAULTS",
           "FenceGuard", "Lease", "LeaseLost", "LeaseStore", "Promotion",
           "promote", "ShippedReplica", "ShipStall", "TransportError",
           "WalShipClient", "WalShipServer"]
