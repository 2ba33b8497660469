"""The port's replica router (``repro_torch.serve.router``) on the CPU: the
reference's ``test_router.py`` cases (mode stamping, read-your-writes
session tokens, heartbeat failure detection under injected starvation,
write fail-fast while leaderless, recovery through ``set_leader``), and a
leader, replica and degraded read whose tickets equal the reference
router's over equal trees.  Every front-end started here is stopped in
``finally``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.stream as JS  # noqa: E402
from repro.core import smtree as J  # noqa: E402
from repro.serve import frontend as JFE  # noqa: E402
from repro.serve import router as JR  # noqa: E402
from repro_torch.core import smtree as T  # noqa: E402
from repro_torch.core.metric import pairwise  # noqa: E402
from repro_torch.serve.frontend import FrontendConfig, ServeFrontend  # noqa: E402
from repro_torch.serve.router import (LeaderUnavailable, ReplicaRouter,  # noqa: E402
                                      SessionToken, StaleReplica)
from repro_torch.stream import Replica, StreamingEngine, WriteAheadLog  # noqa: E402
from repro_torch.stream.faults import FaultInjector, FaultPlan  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

N, DIM = 300, 6


def _stack(tmp_path, seed=0):
    """Leader engine + front-end + one filesystem replica."""
    X = np.random.default_rng(seed).random((N, DIM)).astype(np.float32)
    tree0 = T.bulk_build(X, capacity=8, device="cpu")
    wal = WriteAheadLog(str(tmp_path / "wal"))
    leader = StreamingEngine(tree0, wal=wal)
    fe = ServeFrontend(leader, FrontendConfig(cohort_width=4, slo_ms=5.0,
                                              k=3, max_frontier=256)).start()
    rep = Replica(StreamingEngine(tree0), str(tmp_path / "wal"))
    return X, leader, fe, rep


@pytest.mark.timeout(60)
def test_leader_reads_and_session_tokens(tmp_path):
    X, leader, fe, rep = _stack(tmp_path)
    try:
        router = ReplicaRouter(fe, [rep], k=3, max_frontier=256)
        q = np.random.default_rng(1).random(DIM).astype(np.float32)
        tk = router.query(q)
        d, _ = tk.result(30)
        assert tk.mode == "leader" and tk.staleness == 0
        want = np.sort(pairwise(leader.tree.metric, q[None], X), axis=1)[0, :3]
        np.testing.assert_allclose(d.numpy(), want, atol=1e-5)
        res, token = router.mutate(np.full(4, 1, np.int32),
                                   np.full((4, DIM), 0.5, np.float32),
                                   np.arange(900, 904, dtype=np.int32))
        assert token.wal_seq == 0
        assert SessionToken().merge(token) == token
    finally:
        fe.stop()


@pytest.mark.timeout(60)
def test_replica_mode_respects_session_floor(tmp_path):
    X, leader, fe, rep = _stack(tmp_path, seed=2)
    try:
        router = ReplicaRouter(fe, [rep], k=3, max_frontier=256, prefer_replicas=True)
        _, token = router.mutate(np.full(4, 1, np.int32),
                                 np.full((4, DIM), 0.25, np.float32),
                                 np.arange(900, 904, dtype=np.int32))
        q = np.full(DIM, 0.25, np.float32)
        tk = router.query(q, session=token)     # replica behind the floor
        tk.result(30)
        assert tk.mode == "leader"
        tk2 = router.query(q)                   # fresh session: replica serves
        tk2.result(30)
        assert tk2.mode == "replica"
        rep.poll()                              # caught up: floor satisfied
        tk3 = router.query(q, session=token)
        d3, i3 = tk3.result(30)
        assert tk3.mode == "replica"
        assert 900 in i3.tolist()               # read-your-writes
    finally:
        fe.stop()


@pytest.mark.timeout(60)
def test_heartbeat_starvation_degrades_reads(tmp_path):
    X, leader, fe, rep = _stack(tmp_path, seed=3)
    try:
        rep.poll()
        fault = FaultInjector(FaultPlan(seed=0, heartbeat_drop_p=1.0))
        router = ReplicaRouter(fe, [rep], fault=fault, miss_limit=3, k=3, max_frontier=256)
        assert router.leader_up
        for _ in range(3):
            router.heartbeat()        # every delivery starved
        assert not router.leader_up
        q = np.random.default_rng(4).random(DIM).astype(np.float32)
        tk = router.query(q)
        d, _ = tk.result(30)
        assert tk.mode == "degraded"
        assert tk.staleness == 0      # caught up before the leader "died"
        want = np.sort(pairwise(leader.tree.metric, q[None], X), axis=1)[0, :3]
        np.testing.assert_allclose(d.numpy(), want, atol=1e-5)
        with pytest.raises(LeaderUnavailable):
            router.mutate(np.full(1, 1, np.int32), np.zeros((1, DIM), np.float32),
                          np.array([999], np.int32))
        assert router.snapshot()["n_degraded_reads"] == 1
        router.fault = FaultInjector(FaultPlan())
        assert router.heartbeat()     # one healthy heartbeat heals it
        assert router.leader_up
    finally:
        fe.stop()


@pytest.mark.timeout(60)
def test_degraded_respects_max_staleness_and_session(tmp_path):
    X, leader, fe, rep = _stack(tmp_path, seed=5)
    try:
        rep.poll()
        res, token = ReplicaRouter(fe, [rep]).mutate(
            np.full(4, 1, np.int32), np.full((4, DIM), 0.75, np.float32),
            np.arange(900, 904, dtype=np.int32))
        router = ReplicaRouter(fe, [rep], max_staleness=0, k=3, max_frontier=256)
        router.mark_leader_down()
        with pytest.raises(StaleReplica):
            router.query(np.zeros(DIM, np.float32), session=token)
        rep.note_leader_seq(token.wal_seq)
        assert rep.lag == 1
        rep.poll()
        assert rep.lag == 0
        tk = router.query(np.zeros(DIM, np.float32), session=token)
        tk.result(30)
        assert tk.mode == "degraded" and tk.staleness == 0
    finally:
        fe.stop()


@pytest.mark.timeout(60)
def test_set_leader_restores_writes(tmp_path):
    X, leader, fe, rep = _stack(tmp_path, seed=6)
    try:
        router = ReplicaRouter(fe, [rep])
        router.mark_leader_down()
        with pytest.raises(LeaderUnavailable):
            router.mutate(np.full(1, 1, np.int32), np.zeros((1, DIM), np.float32),
                          np.array([999], np.int32))
        router.set_leader(fe)
        res, token = router.mutate(np.full(1, 1, np.int32), np.zeros((1, DIM), np.float32),
                                   np.array([999], np.int32))
        assert token.wal_seq == 0
    finally:
        fe.stop()


@pytest.mark.timeout(120)
def test_routed_tickets_equal_the_reference_router(tmp_path):
    """Leader, replica and degraded reads, a write's session token, and the
    router's counters: equal to the reference router's over equal trees
    (the port's ``bulk_build`` is bitwise to the JAX package's)."""
    rng = np.random.default_rng(12)
    X = rng.random((N, DIM)).astype(np.float32)
    Q = rng.random((6, DIM)).astype(np.float32)
    wx = rng.random((5, DIM)).astype(np.float32)
    pkgs = {"port": (T.bulk_build(X, capacity=8, device="cpu"), StreamingEngine,
                     WriteAheadLog, Replica, ServeFrontend, FrontendConfig, ReplicaRouter),
            "reference": (J.bulk_build(X, capacity=8), JS.StreamingEngine, JS.WriteAheadLog,
                          JS.Replica, JFE.ServeFrontend, JFE.FrontendConfig,
                          JR.ReplicaRouter)}
    out = {}
    for name, (tree0, SE, WAL, Rep, FE, Cfg, Router) in pkgs.items():
        leader = SE(tree0, wal=WAL(str(tmp_path / name / "wal")))
        fe = FE(leader, Cfg(cohort_width=4, slo_ms=5.0, k=3, max_frontier=16)).start()
        try:
            rep = Rep(SE(tree0), str(tmp_path / name / "wal"))
            router = Router(fe, [rep], k=3, max_frontier=16, prefer_replicas=True)
            _, token = router.mutate(np.full(5, T.OP_INSERT, np.int32), wx,
                                     np.arange(900, 905, dtype=np.int32))
            rows = []
            for q in Q[:3]:                      # leader (floor unmet)
                tk = router.query(q, session=token)
                rows.append((tk, *tk.result(30)))
            rep.poll()
            for q in Q[3:]:                      # replica (floor met)
                tk = router.query(q, session=token)
                rows.append((tk, *tk.result(30)))
            router.mark_leader_down()
            for q in Q[:2]:                      # degraded
                tk = router.query(q)
                rows.append((tk, *tk.result(30)))
            out[name] = (token, [(tk.mode, tk.staleness, tk.epoch, np.asarray(d), np.asarray(i))
                                 for tk, d, i in rows],
                         {k: v for k, v in router.snapshot().items()
                          if k.startswith("n_") or k == "replica_lags"})
        finally:
            fe.stop()
    (tp, rows_p, snap_p), (tr, rows_r, snap_r) = out["port"], out["reference"]
    assert (tp.epoch, tp.wal_seq) == (tr.epoch, tr.wal_seq)
    assert [r[0] for r in rows_p] == ["leader"] * 3 + ["replica"] * 3 + ["degraded"] * 2
    for a, b in zip(rows_p, rows_r):
        assert a[:3] == b[:3]
        np.testing.assert_array_equal(a[3], b[3])
        np.testing.assert_array_equal(a[4], b[4])
    assert snap_p == snap_r
