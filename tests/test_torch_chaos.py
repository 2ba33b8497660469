"""The seeded failover drill on the port: the reference's ``test_chaos.py``
with the port's transport, lease, front-end and router.

The leader is killed mid-batch (a torn half-frame in its WAL) while 5%
frame drop and 5% reorder are injected into the shipping layer.  Under
each pinned seed the replica is promoted under a strictly higher fencing
token, its digest equals the pre-kill leader's last acknowledged state and
the reference engine's digest over the same acknowledged batches, the torn
batch is cleanly absent, reads are served throughout (degraded while
leaderless), writes fail fast and flow again after ``set_leader``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.stream as JS  # noqa: E402
from repro.core import smtree as J  # noqa: E402
from repro_torch.core import smtree as T  # noqa: E402
from repro_torch.serve.frontend import FrontendConfig, ServeFrontend  # noqa: E402
from repro_torch.serve.router import LeaderUnavailable, ReplicaRouter  # noqa: E402
from repro_torch.stream import (FencedOut, StreamingEngine, WriteAheadLog,  # noqa: E402
                                iter_wal, ledger_digest)
from repro_torch.stream.faults import FaultInjector, FaultPlan  # noqa: E402
from repro_torch.stream.lease import FenceGuard, LeaseStore, promote  # noqa: E402
from repro_torch.stream.transport import ShippedReplica, WalShipServer  # noqa: E402
from repro_torch.stream.wal import KIND_BATCH, WalRecord, _encode, _scan_dir  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

DIM = 6
SEEDS = [101, 202, 303]


class ManualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _reference_digest(X, acked_batches):
    """The reference engine over the same tree and the same acknowledged
    batches: its published epoch's digest."""
    eng = JS.StreamingEngine(J.bulk_build(X, capacity=8))
    for ops, xs, oids in acked_batches:
        eng.apply(ops, xs, oids, log=False)
    with eng.epochs.reading() as pinned:
        return JS.tree_digest(pinned)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("seed", SEEDS)
def test_failover_drill(tmp_path, seed):
    rng = np.random.default_rng(seed)
    clock = ManualClock()
    store = LeaseStore(str(tmp_path / "lease"), ttl_s=5.0, clock=clock)
    grant = store.try_acquire("leader")

    X = rng.random((300, DIM)).astype(np.float32)
    tree0 = T.bulk_build(X, capacity=8, device="cpu")
    wal = WriteAheadLog(str(tmp_path / "wal"), segment_max_records=3,
                        fence=FenceGuard(store, "leader", grant.token))
    leader = StreamingEngine(tree0, wal=wal)
    fe = ServeFrontend(leader, FrontendConfig(cohort_width=4, slo_ms=5.0,
                                              k=3, max_frontier=256)).start()
    fault = FaultInjector(FaultPlan(seed=seed, drop_p=0.05, reorder_p=0.05))
    srv = WalShipServer(str(tmp_path / "wal"), wal=wal, fault=fault,
                        chunk_bytes=64, max_chunks=256).start()
    rep = ShippedReplica(StreamingEngine(tree0), srv.address,
                         str(tmp_path / "mirror"), seed=seed)
    router = ReplicaRouter(fe, [rep], k=3, max_frontier=256)
    fe2 = None
    try:
        # -- phase 1: acknowledged traffic, replica shipping behind ------
        acked, batches = [], []
        for i in range(int(rng.integers(4, 8))):
            oids = np.arange(1000 + 16 * i, 1016 + 16 * i, dtype=np.int32)
            ops = np.full(16, T.OP_INSERT, np.int32)
            xs = rng.random((16, DIM)).astype(np.float32)
            res, token = router.mutate(ops, xs, oids)
            acked.append((token.wal_seq, oids))
            batches.append((ops, xs, oids))
        seq, dg = ledger_digest(leader)         # last acknowledged state
        assert seq == acked[-1][0]
        assert dg == _reference_digest(X, batches)

        # -- phase 2: kill mid-batch at a seeded point inside the frame --
        frame = _encode(WalRecord(KIND_BATCH, seq + 1, ops=np.full(16, T.OP_INSERT, np.int8),
                                  oids=np.arange(9000, 9016, dtype=np.int32),
                                  xs=rng.random((16, DIM)).astype(np.float32)))
        cut = int(rng.integers(1, len(frame) - 1))
        wal.close()
        names = _scan_dir(str(tmp_path / "wal"))
        with open(os.path.join(str(tmp_path / "wal"), names[-1]), "ab") as f:
            f.write(frame[:cut])
        fe.stop()                               # leader process is gone
        router.mark_leader_down()

        # -- phase 3: reads keep flowing, degraded-stamped; writes bounce
        q = rng.random(DIM).astype(np.float32)
        tk = router.query(q)
        tk.result(30)
        assert tk.mode == "degraded" and tk.staleness >= 0
        with pytest.raises(LeaderUnavailable):
            router.mutate(np.full(1, T.OP_INSERT, np.int32),
                          np.zeros((1, DIM), np.float32), np.array([99], np.int32))

        # -- phase 4: promote under a higher fence -----------------------
        clock.t = 6.0                           # the dead leader's lease lapses
        promo = promote(rep, store, "follower-1", target=(seq, dg), drain_timeout=60.0)
        assert promo.lease.token > grant.token
        assert promo.digest == dg and promo.applied_seq == seq

        mirror_recs = {r.seq: r for r in iter_wal(str(tmp_path / "mirror"))}
        for s, oids in acked:
            np.testing.assert_array_equal(mirror_recs[s].oids, oids)
        assert seq + 1 not in mirror_recs       # the torn batch is absent
        assert promo.wal.next_seq == seq + 1

        zombie = WriteAheadLog(str(tmp_path / "wal"),
                               fence=FenceGuard(store, "leader", grant.token))
        with pytest.raises(FencedOut):
            zombie.append_batch(np.full(1, T.OP_INSERT, np.int8),
                                np.zeros((1, DIM), np.float32), np.array([1], np.int32))
        zombie.close()

        # -- phase 5: the promoted follower serves writes again ----------
        fe2 = ServeFrontend(rep.follower, FrontendConfig(cohort_width=4, slo_ms=5.0, k=3,
                                                         max_frontier=256)).start()
        router.set_leader(fe2)
        res, token = router.mutate(np.full(4, T.OP_INSERT, np.int32),
                                   rng.random((4, DIM)).astype(np.float32),
                                   np.arange(7000, 7004, dtype=np.int32))
        assert token.wal_seq == seq + 1         # numbering continues, no gap
        tk = router.query(q, session=token)
        tk.result(30)
        assert tk.mode == "leader"
        promo.wal.close()
    finally:
        for fe_ in (fe, fe2):
            if fe_ is not None:
                fe_.stop()
        rep.stop()
        srv.stop()
    assert fault.counts["drop"] + fault.counts["reorder"] > 0
