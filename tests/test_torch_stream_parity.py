"""The port's stream plane against the JAX package, by ``tree_digest``.

The same seeded numpy logs go through ``repro.stream`` and
``repro_torch.stream``; the reference's ``tree_digest`` of its trees and
the port's of its own must be equal (they hash the same bytes in the same
order).  Covered: ``StreamingEngine`` over mixed logs that cut into
several cohorts; the host-mode ``StreamingForest`` (the reference's mesh
mode does not run on jax 0.9.0: ROADMAP "Reference caveats") draining one
shard, in both rebalance modes, beside the port's stacked plane; snapshot
+ WAL-tail restore across the two packages both ways, for the forest from
a snapshot taken between migration steps; a ``Replica`` of either package
tailing the other's WAL; pinned forest kNN.  Each JAX run happens once per
module (fixtures), with small geometry: dim 6, capacity 8, max_batch 64.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401

import repro.stream as JS  # noqa: E402
from repro.core import distributed as JD  # noqa: E402
from repro.core import smtree as J  # noqa: E402
from repro.dist import checkpoint as JC  # noqa: E402
import repro_torch.stream as TS  # noqa: E402
from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.core import smtree as T  # noqa: E402
from repro_torch.data.datagen import clustered  # noqa: E402
from repro_torch.dist import checkpoint as TC  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

S = 4
N = 1200
ENGINE_KW = dict(max_batch=64)
FOREST_KW = dict(max_batch=64, max_skew=1.3, min_objects=64, migration_step_objects=16)
SNAP_ENGINE_AT = 2        # the engine's snapshot: after this batch
SNAP_FOREST_AT = 2        # the forest's: after this batch's maintenance
EXTRA_STEPS = 8           # maintenance calls after the forest's log
MODES = ("stop_world", "incremental")


def _X():
    return clustered(N, dims=6, seed=0)


def _engine_log():
    """Six batches of 150 rows: deletes of live ids, inserts of new ids
    near the data, and re-inserts of ids deleted earlier in the same batch
    (a repeat starts a cohort)."""
    rng = np.random.default_rng(1)
    X = _X()
    live = {i: X[i] for i in range(N)}
    nxt, out = 5000, []
    for _ in range(6):
        ops, xs, oids, gone = [], [], [], []
        for _ in range(150):
            r = rng.random()
            if r < 0.45 and live:
                o = list(live)[int(rng.integers(len(live)))]
                ops.append(T.OP_DELETE), xs.append(live.pop(o)), oids.append(o)
                gone.append(o)
            elif r < 0.5 and gone:
                o = gone.pop()
                x = (X[o % N] + 0.002).astype(np.float32)
                live[o] = x
                ops.append(T.OP_INSERT), xs.append(x), oids.append(o)
            else:
                x = (X[rng.integers(N)] + rng.normal(0, 0.01, 6)).astype(np.float32)
                live[nxt] = x
                ops.append(T.OP_INSERT), xs.append(x), oids.append(nxt)
                nxt += 1
        out.append((np.array(ops, np.int32), np.array(xs, np.float32),
                    np.array(oids, np.int32)))
    return out


def _forest_log():
    """Five batches: 40 deletes of shard 0's ids (oid % 4 == 0) and 10
    inserts of new ids, so shard 0 drains and the skew trigger fires."""
    X = _X()
    drain = np.arange(0, N, S)
    out = []
    for b in range(5):
        ids = drain[40 * b:40 * (b + 1)]
        new = 9000 + 10 * b + np.arange(10)
        ops = np.concatenate([np.full(40, T.OP_DELETE), np.full(10, T.OP_INSERT)]).astype(np.int32)
        xs = np.vstack([X[ids], X[ids[:10]] + 0.003]).astype(np.float32)
        out.append((ops, xs, np.concatenate([ids, new]).astype(np.int32)))
    return out


def _run_engine(pkg, root, tree, **kw):
    """The engine log with a WAL and a snapshot after batch SNAP_ENGINE_AT:
    (engine, digest after every batch, ledger digest)."""
    S_, C_ = pkg
    wal = S_.WriteAheadLog(str(root / "wal"))
    ckpt = C_.CheckpointManager(str(root / "ck"), async_write=False)
    eng = S_.StreamingEngine(tree, wal=wal, ckpt=ckpt, **ENGINE_KW, **kw)
    digests = []
    for i, b in enumerate(_engine_log()):
        eng.apply(*b)
        digests.append(S_.tree_digest(eng.tree))
        if i == SNAP_ENGINE_AT:
            eng.snapshot()
    return eng, digests, S_.ledger_digest(eng)


def _run_forest(pkg, root, trees, mode, **kw):
    """The forest drill: each batch then one ``maintenance()``, a snapshot
    after batch SNAP_FOREST_AT's, then EXTRA_STEPS more maintenance calls:
    (forest, digest after every call, migration active at the snapshot)."""
    S_, C_ = pkg
    wal = S_.WriteAheadLog(str(root / "wal"))
    ckpt = C_.CheckpointManager(str(root / "ck"), async_write=False)
    f = S_.StreamingForest(trees, wal=wal, ckpt=ckpt, rebalance_mode=mode,
                           **FOREST_KW, **kw)
    digests, mid = [], None
    for i, b in enumerate(_forest_log()):
        f.apply(*b)
        digests.append(S_.tree_digest(f.trees))
        f.maintenance()
        digests.append(S_.tree_digest(f.trees))
        if i == SNAP_FOREST_AT:
            f.snapshot()
            mid = f.migration_active
    for _ in range(EXTRA_STEPS):
        f.maintenance()
        digests.append(S_.tree_digest(f.trees))
    return f, digests, mid


JAX, PORT = (JS, JC), (TS, TC)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    X = _X()
    jroot, troot = tmp_path_factory.mktemp("jax_eng"), tmp_path_factory.mktemp("port_eng")
    j = _run_engine(JAX, jroot, J.bulk_build(X, capacity=8))
    t = _run_engine(PORT, troot, T.bulk_build(X, capacity=8, device="cpu"))
    return dict(jax=j, port=t, jroot=jroot, troot=troot)


@pytest.fixture(scope="module", params=MODES)
def forests(request, tmp_path_factory):
    mode = request.param
    X = _X()
    roots = {k: tmp_path_factory.mktemp(f"{k}_{mode}") for k in ("jax", "host", "stacked")}
    j = _run_forest(JAX, roots["jax"], JD.build_forest_trees(X, S, capacity=8), mode)
    host = _run_forest(PORT, roots["host"],
                       TD.build_forest_trees(X, S, capacity=8, device="cpu"), mode)
    stacked = _run_forest(PORT, roots["stacked"],
                          TD.build_forest_trees(X, S, capacity=8, device="cpu"), mode,
                          mesh="cpu")
    return dict(mode=mode, jax=j, host=host, stacked=stacked, roots=roots)


# ---------------------------------------------------------------------------
# the single-tree engine
# ---------------------------------------------------------------------------
def test_engine_digests_match_jax_after_every_batch(engines):
    jeng, jd, _ = engines["jax"]
    teng, td, _ = engines["port"]
    assert td == jd
    assert len(set(td)) == len(td)            # every batch changed the tree
    assert teng.wal.next_seq == jeng.wal.next_seq == 6


def test_engine_with_the_passes_off_matches_jax(tmp_path):
    """Every overflow and underflow row through the host plane."""
    X = _X()
    kw = dict(device_splits=False, device_merges=False)
    j = JS.StreamingEngine(J.bulk_build(X, capacity=8), **ENGINE_KW, **kw)
    t = TS.StreamingEngine(T.bulk_build(X, capacity=8, device="cpu"), **ENGINE_KW, **kw)
    for b in _engine_log()[:3]:
        rj, rt = j.apply(*b), t.apply(*b)
        np.testing.assert_array_equal(rt.statuses, rj.statuses)
        assert rt.n_escalated == rj.n_escalated > 0
        assert TS.tree_digest(t.tree) == JS.tree_digest(j.tree)


def test_jax_snapshot_and_wal_restore_in_the_port(engines):
    root = engines["jroot"]
    got = TS.StreamingEngine.restore(str(root / "ck"),
                                     wal=TS.WriteAheadLog(str(root / "wal")),
                                     device="cpu", **ENGINE_KW)
    assert TS.tree_digest(got.tree) == engines["jax"][1][-1]


def test_port_snapshot_and_wal_restore_in_jax(engines):
    root = engines["troot"]
    got = JS.StreamingEngine.restore(str(root / "ck"),
                                     wal=JS.WriteAheadLog(str(root / "wal")),
                                     **ENGINE_KW)
    assert JS.tree_digest(got.tree) == engines["port"][1][-1]


def test_port_replica_tails_a_jax_wal(engines):
    root = engines["jroot"]
    rep = TS.Replica.from_snapshot(str(root / "ck"), str(root / "wal"),
                                   device="cpu", **ENGINE_KW)
    assert rep.applied_seq == SNAP_ENGINE_AT
    seq, digest = engines["jax"][2]
    rep.verify(seq, digest, timeout=60)
    assert rep.digest() == (seq, digest) and rep.lag == 0


def test_jax_replica_tails_a_port_wal(engines):
    root = engines["troot"]
    rep = JS.Replica.from_snapshot(str(root / "ck"), str(root / "wal"), **ENGINE_KW)
    seq, digest = engines["port"][2]
    rep.verify(seq, digest, timeout=60)
    # the digest exchange catches a divergence: an older digest at this seq
    prep = TS.Replica.from_snapshot(str(root / "ck"), str(root / "wal"),
                                    device="cpu", **ENGINE_KW)
    with pytest.raises(TS.DigestMismatch):
        prep.verify(seq, engines["port"][1][0], timeout=60)


# ---------------------------------------------------------------------------
# the forest, host mode and the stacked plane, both rebalance modes
# ---------------------------------------------------------------------------
def test_forest_digests_match_jax(forests):
    jf, jd, jmid = forests["jax"]
    tf, td, tmid = forests["host"]
    assert td == jd and tmid == jmid
    assert tf.n_rebalances == jf.n_rebalances >= 1
    assert tf.n_migration_steps == jf.n_migration_steps
    assert tf.owner == jf.owner
    if forests["mode"] == "incremental":
        assert jmid, "the snapshot was not taken between migration steps"
        assert tf.n_migration_steps > 1


def test_forest_planes_are_bitwise_equal(forests):
    _, hd, _ = forests["host"]
    _, sd, _ = forests["stacked"]
    assert sd == hd


def test_jax_forest_snapshot_restores_in_the_port(forests):
    root = forests["roots"]["jax"]
    for mesh in (None, "cpu"):
        got = TS.StreamingForest.restore(str(root / "ck"),
                                         wal=TS.WriteAheadLog(str(root / "wal")),
                                         device="cpu", mesh=mesh, **FOREST_KW)
        assert TS.tree_digest(got.trees) == forests["jax"][1][-1]
        assert got.owner == forests["jax"][0].owner


def test_port_forest_snapshot_restores_in_jax(forests):
    root = forests["roots"]["stacked"]
    got = JS.StreamingForest.restore(str(root / "ck"),
                                     wal=JS.WriteAheadLog(str(root / "wal")),
                                     **FOREST_KW)
    assert JS.tree_digest(got.trees) == forests["stacked"][1][-1]


def test_port_forest_replica_tails_a_jax_wal(forests):
    root = forests["roots"]["jax"]
    rep = TS.Replica.from_snapshot(str(root / "ck"), str(root / "wal"),
                                   device="cpu", **FOREST_KW)
    jf = forests["jax"][0]
    rep.verify(jf.wal.next_seq - 1, forests["jax"][1][-1], timeout=120)


def test_pinned_forest_knn_matches_jax(forests):
    jf, tf = forests["jax"][0], forests["host"][0]
    q = (_X()[::97][:12] + 0.004).astype(np.float32)
    jd, ji = jf.knn(q, k=5, max_frontier=64)
    for f in (tf, forests["stacked"][0]):
        d, i = f.knn(q, k=5, max_frontier=64)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
