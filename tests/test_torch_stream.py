"""The port's stream plane on its own (no JAX): cohort batching and its
adversarial same-id logs, the one copy per batch that keeps pinned epochs
intact, the WAL (framing, rotation, torn tails, group commit, the fence,
the follower cursor), epochs under concurrency, the checkpoint format,
the rebalance planner and the observability plane.  Held against the JAX
package in tests/test_torch_stream_parity.py.
"""
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.core.engine import SMTreeEngine  # noqa: E402
from repro_torch.core.smtree import (OP_DELETE, OP_INSERT, ST_APPLIED,  # noqa: E402
                                     ST_NOTFOUND, bulk_build, knn)
from repro_torch.data.datagen import clustered, uniform  # noqa: E402
from repro_torch.dist.checkpoint import (CheckpointManager,  # noqa: E402
                                         restore_checkpoint, save_checkpoint)
from repro_torch.stream import (EpochManager, FencedOut, MigrationPlan,  # noqa: E402
                                MutationBatcher, StreamingEngine,
                                StreamingForest, WalCursor, WalTailStall,
                                WriteAheadLog, collect_stats, cut_cohorts,
                                iter_wal, needs_rebalance, plan_migration,
                                rebalance_shards, tail_wal, tree_digest)
from repro_torch.stream.batcher import check_oids  # noqa: E402
from repro_torch.stream.rebalance import (GeometryMismatch,  # noqa: E402
                                          check_geometry, live_objects)
from repro_torch.stream.wal import KIND_BATCH, KIND_REBALANCE  # noqa: E402

DEV = "cpu"


def _tree(n=600, seed=1, capacity=8, metric="d_inf"):
    X = clustered(n, dims=6, seed=seed)
    return X, bulk_build(X, capacity=capacity, metric=metric, device=DEV)


def _live(tree):
    return set(live_objects(tree)[1].tolist())


# ---------------------------------------------------------------------------
# cohort cutting and the batcher
# ---------------------------------------------------------------------------
def test_cut_cohorts_no_conflicts_single_run():
    assert cut_cohorts(np.array([1, 2, 3, 4])) == [(0, 4)]


def test_cut_cohorts_splits_at_repeats():
    assert cut_cohorts(np.array([7, 1, 7, 2, 7])) == [(0, 2), (2, 4), (4, 5)]
    assert cut_cohorts(np.array([], np.int32)) == [(0, 0)]


def test_negative_oids_rejected_before_the_wal(tmp_path):
    with pytest.raises(ValueError, match="reserved"):
        check_oids(np.array([3, -1]))
    _, tree = _tree(100)
    wal = WriteAheadLog(str(tmp_path / "wal"))
    eng = StreamingEngine(tree, wal=wal)
    with pytest.raises(ValueError, match="reserved"):
        eng.insert_batch(np.zeros((1, 6), np.float32), np.array([-1]))
    assert wal.next_seq == 0


def test_batched_mixed_stream_matches_semantics():
    """The live set, validate() and exact queries after a mixed batch that
    cuts into several cohorts, splits and merges."""
    rng = np.random.default_rng(0)
    X, tree = _tree()
    extra = uniform(80, dims=6, seed=2)
    ops = np.concatenate([np.full(150, OP_DELETE), np.full(80, OP_INSERT)])
    oids = np.concatenate([rng.permutation(600)[:150], 600 + np.arange(80)]).astype(np.int32)
    xs = np.concatenate([X[oids[:150]], extra]).astype(np.float32)
    perm = rng.permutation(len(ops))
    ops, oids, xs = ops[perm].astype(np.int32), oids[perm], xs[perm]
    b = MutationBatcher(tree, max_batch=64)
    res = b.apply(ops, xs, oids)
    assert (res.statuses == ST_APPLIED).all()
    assert res.n_split + res.n_merge > 0 and res.n_escalated == 0
    assert res.n_fast + res.n_split + res.n_merge == len(ops)
    want = (set(range(600)) - set(oids[ops == OP_DELETE].tolist())) | set(range(600, 680))
    assert _live(b.tree) == want
    assert SMTreeEngine(b.tree).validate()
    keep = sorted(want)
    allx = np.vstack([X, extra])
    q = allx[keep[:5]] + 1e-3
    r = knn(b.tree, q, k=3, max_frontier=512)
    d = np.max(np.abs(allx[keep][None] - q[:, None]), -1)
    np.testing.assert_array_equal(r.dists.numpy(), np.sort(d, 1)[:, :3])


def test_adversarial_same_id_interleaved():
    """insert / delete / insert of one id in one log: each repeat starts a
    cohort, so the last insert wins, with its vector."""
    X, tree = _tree(200)
    x1, x2 = X[0] + 0.3, X[1] + 0.3
    ops = np.array([OP_INSERT, OP_DELETE, OP_INSERT, OP_DELETE, OP_INSERT], np.int32)
    oids = np.array([900, 900, 900, 5, 5], np.int32)
    xs = np.stack([x1, x1, x2, X[5], X[5]]).astype(np.float32)
    b = MutationBatcher(tree)
    res = b.apply(ops, xs, oids)
    assert res.n_cohorts == 4 and (res.statuses == ST_APPLIED).all()
    vecs, oid = live_objects(b.tree)
    np.testing.assert_array_equal(vecs[oid == 900][0], x2.astype(np.float32))
    assert 5 in set(oid.tolist())


def test_delete_to_empty_then_reinsert():
    X, tree = _tree(40)
    b = MutationBatcher(tree, max_batch=16)
    ids = np.arange(40, dtype=np.int32)
    res = b.apply(np.full(40, OP_DELETE, np.int32), X, ids)
    assert (res.statuses == ST_APPLIED).all() and b.tree.n_objects == 0
    res = b.apply(np.full(40, OP_INSERT, np.int32), X, ids)
    assert (res.statuses == ST_APPLIED).all() and _live(b.tree) == set(range(40))
    assert SMTreeEngine(b.tree).validate()


def test_notfound_delete_reported():
    X, tree = _tree(100)
    res = MutationBatcher(tree).apply(np.array([OP_DELETE] * 2, np.int32),
                                      X[:2], np.array([5000, 3], np.int32))
    assert res.statuses.tolist() == [ST_NOTFOUND, ST_APPLIED]


@pytest.mark.parametrize("metric", ["d_inf", "l2", "l1"])
def test_duplicate_vectors_under_all_metrics(metric):
    """Many objects on one point (zero distances everywhere): splits and
    merges still keep every id, under every metric."""
    X, tree = _tree(150, metric=metric)
    dup = np.repeat(X[:1], 60, 0)
    ids = 1000 + np.arange(60, dtype=np.int32)
    b = MutationBatcher(tree, max_batch=32)
    assert (b.apply(np.full(60, OP_INSERT, np.int32), dup, ids).statuses == ST_APPLIED).all()
    assert (b.apply(np.full(50, OP_DELETE, np.int32), dup[:50], ids[:50]).statuses
            == ST_APPLIED).all()
    assert _live(b.tree) == set(range(150)) | set(ids[50:].tolist())
    assert SMTreeEngine(b.tree).validate()


def test_batcher_never_writes_the_tree_it_was_given():
    """The defect the per-batch copy prevents: the port's apply writes in
    place, so without the copy a pinned epoch would change under its
    reader.  Pin, apply a batch that splits and merges, and the pinned
    version keeps its digest."""
    X, tree = _tree(300)
    eng = StreamingEngine(tree, max_batch=64)
    with eng.epochs.reading() as pinned:
        before = tree_digest(pinned)
        ops = np.array([OP_DELETE] * 60 + [OP_INSERT] * 60, np.int32)
        oids = np.concatenate([np.arange(60), 5000 + np.arange(60)]).astype(np.int32)
        xs = np.vstack([X[:60], X[:60] + 1e-3]).astype(np.float32)
        res = eng.apply(ops, xs, oids)
        assert res.n_split + res.n_merge > 0
        assert tree_digest(pinned) == before
    assert tree_digest(eng.tree) != before and eng.epochs.resident == [1]


@pytest.mark.parametrize("mesh", [None, DEV])
def test_forest_pinned_epoch_survives_a_batch(mesh):
    """The same for both planes of the forest: a host-plane shard or the
    stacked forest is copied once per batch before it is written."""
    X = clustered(800, dims=6, seed=3)
    f = StreamingForest(TD.build_forest_trees(X, 4, capacity=8, device=DEV),
                        max_batch=64, mesh=mesh)
    f.insert_batch(X[:10] + 1e-3, 5000 + np.arange(10))   # the stacked form now
    with f.epochs.reading() as pinned:
        before = tree_digest(pinned)
        ids = np.arange(0, 400, 2)
        f.delete_batch(X[ids], ids)
        assert tree_digest(pinned) == before
    assert f.n_objects == 800 + 10 - 200


def test_stacked_plane_refuses_shards_elsewhere():
    X = clustered(100, dims=6, seed=3)
    trees = TD.build_forest_trees(X, 2, capacity=8, device=DEV)
    with pytest.raises(ValueError, match="stacked plane"):
        StreamingForest(trees, mesh="meta")


# ---------------------------------------------------------------------------
# the WAL
# ---------------------------------------------------------------------------
def _batch(i, n=3, dim=4):
    return (np.full(n, OP_INSERT, np.int8), np.full((n, dim), i, np.float32),
            np.arange(n, dtype=np.int32) + 10 * i)


def test_wal_rotation_and_strict_manifest(tmp_path):
    d = str(tmp_path / "wal")
    with WriteAheadLog(d, segment_max_records=2) as wal:
        for i in range(5):
            wal.append_batch(*_batch(i))
        wal.append_rebalance({"seed": 9})
    segs = sorted(n for n in os.listdir(d) if n.endswith(".wal"))
    assert len(segs) == 3
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    assert [s["records"] for s in man["segments"]] == [2, 2, 2] and man["next_seq"] == 6
    recs = list(iter_wal(d))
    assert [r.kind for r in recs] == [KIND_BATCH] * 5 + [KIND_REBALANCE]
    assert [r.seq for r in recs] == list(range(6)) and recs[-1].params == {"seed": 9}
    np.testing.assert_array_equal(recs[3].xs, np.full((3, 4), 3, np.float32))


def test_wal_reopen_continues_sequence(tmp_path):
    d = str(tmp_path / "wal")
    with WriteAheadLog(d, segment_max_records=2) as wal:
        for i in range(3):
            wal.append_batch(*_batch(i))
    with WriteAheadLog(d, segment_max_records=2) as wal:
        assert wal.next_seq == 3
        assert wal.append_batch(*_batch(3)) == 3
    assert [r.seq for r in iter_wal(d, after_seq=1)] == [2, 3]


def test_wal_torn_tail_tolerated_and_truncated_on_reopen(tmp_path):
    d = str(tmp_path / "wal")
    with WriteAheadLog(d) as wal:
        wal.append_batch(*_batch(0))
        wal.append_batch(*_batch(1))
    seg = os.path.join(d, sorted(n for n in os.listdir(d) if n.endswith(".wal"))[-1])
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - 5)
    assert [r.seq for r in iter_wal(d)] == [0]
    with WriteAheadLog(d) as wal:
        assert wal.next_seq == 1
        wal.append_batch(*_batch(7))
    recs = list(iter_wal(d))
    assert [r.seq for r in recs] == [0, 1]
    np.testing.assert_array_equal(recs[1].xs, np.full((3, 4), 7, np.float32))


def test_wal_corrupt_sealed_segment_raises(tmp_path):
    d = str(tmp_path / "wal")
    with WriteAheadLog(d, segment_max_records=1) as wal:
        wal.append_batch(*_batch(0))
        wal.append_batch(*_batch(1))
    first = os.path.join(d, sorted(n for n in os.listdir(d) if n.endswith(".wal"))[0])
    with open(first, "r+b") as f:
        f.seek(os.path.getsize(first) - 3)
        f.write(b"\xff\xff\xff")
    with pytest.raises(ValueError, match="corrupt sealed"):
        list(iter_wal(d))


def test_wal_group_commit_concurrent_appends(tmp_path):
    d = str(tmp_path / "wal")
    wal = WriteAheadLog(d, segment_max_records=16, sync=True, group_commit=True)
    T, PER = 4, 24
    errs = []

    def worker(t):
        try:
            for i in range(PER):
                wal.append_batch(np.full(3, OP_INSERT, np.int8),
                                 np.zeros((3, 4), np.float32),
                                 np.arange(3, dtype=np.int32) + 1000 * t + 10 * i)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(T)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    wal.close()
    assert not errs, errs
    seqs = [r.seq for r in iter_wal(d)]
    assert seqs == list(range(T * PER))
    assert wal._synced == wal._appended == T * PER


def test_wal_group_commit_single_thread_equivalent(tmp_path):
    logs = {}
    for name, group in (("plain", False), ("group", True)):
        d = str(tmp_path / name)
        with WriteAheadLog(d, sync=True, group_commit=group) as wal:
            for i in range(5):
                wal.append_batch(*_batch(i))
        logs[name] = b"".join(open(os.path.join(d, n), "rb").read()
                              for n in sorted(os.listdir(d)) if n.endswith(".wal"))
    assert logs["plain"] == logs["group"]


def test_wal_fence_refuses_the_append(tmp_path):
    d = str(tmp_path / "wal")
    wal = WriteAheadLog(d)
    wal.append_batch(*_batch(0))

    def fence():
        raise FencedOut("stale token")

    wal.fence = fence
    with pytest.raises(FencedOut):
        wal.append_batch(*_batch(1))
    wal.close()
    assert wal.next_seq == 1 and [r.seq for r in iter_wal(d)] == [0]


def test_tail_wal_incremental_fast_forward_and_torn_resume(tmp_path):
    d = str(tmp_path / "wal")
    wal = WriteAheadLog(d, segment_max_records=2)
    for i in range(3):                  # segment 0 sealed {0, 1}, 1 active {2}
        wal.append_batch(*_batch(i))
    wal.close()
    recs, cur = tail_wal(d, WalCursor())
    assert [r.seq for r in recs] == [0, 1, 2]
    assert tail_wal(d, cur)[0] == []
    # a torn frame in the active segment parks the cursor before it
    seg = os.path.join(d, sorted(n for n in os.listdir(d) if n.endswith(".wal"))[-1])
    full = open(seg, "rb").read()
    with open(seg, "r+b") as f:
        f.truncate(len(full) - 4)
    recs, cur = tail_wal(d, WalCursor(seq=1))   # fast-forwards over segment 0
    assert recs == [] and (cur.segment, cur.offset, cur.stalls) == (1, 0, 0)
    recs, cur = tail_wal(d, cur)
    assert recs == [] and cur.stalls == 1
    with open(seg, "wb") as f:                   # the append completes
        f.write(full)
    recs, cur = tail_wal(d, cur)
    assert [r.seq for r in recs] == [2] and cur.stalls == 0


def test_tail_wal_bounded_and_stall_diagnostic(tmp_path):
    d = str(tmp_path / "wal")
    with WriteAheadLog(d) as wal:
        for i in range(5):
            wal.append_batch(*_batch(i))
    seen, cur = [], WalCursor()
    while True:
        recs, cur = tail_wal(d, cur, max_records=2)
        if not recs:
            break
        assert len(recs) <= 2
        seen += [r.seq for r in recs]
    assert seen == list(range(5))
    seg = os.path.join(d, sorted(n for n in os.listdir(d) if n.endswith(".wal"))[-1])
    with open(seg, "ab") as f:
        f.write(b"\x05\x00\x00\x00garbage")
    with pytest.raises(WalTailStall):
        for _ in range(3):
            _, cur = tail_wal(d, cur, max_stalls=3)


# ---------------------------------------------------------------------------
# epochs
# ---------------------------------------------------------------------------
def test_epoch_pin_survives_publish_and_keep_window():
    mgr = EpochManager("v0")
    e, t = mgr.acquire()
    mgr.publish("v1")
    mgr.publish("v2")
    assert t == "v0" and mgr.resident == [0, 2]
    mgr.release(e)
    assert mgr.resident == [2]
    kept = EpochManager("a", keep=2)
    for v in "bcde":
        kept.publish(v)
    assert kept.resident == [2, 3, 4]


def test_epoch_double_release_rejected_and_meta():
    mgr = EpochManager(0)
    e, _ = mgr.acquire()
    mgr.release(e)
    with pytest.raises(ValueError):
        mgr.release(e)
    with pytest.raises(KeyError):
        mgr.release(99)
    e1 = mgr.publish(1, meta={"migration": {"step": 0}})
    assert mgr.meta(e1) == {"migration": {"step": 0}}


def test_pin_hammer_many_readers_one_writer():
    """Readers pin and re-check their version while a writer publishes
    through a real engine: a reader's tree never changes under its pin."""
    X, tree = _tree(200)
    eng = StreamingEngine(tree, max_batch=32)
    stop, errs = threading.Event(), []

    def reader():
        try:
            while not stop.is_set():
                with eng.epochs.reading() as t:
                    d0 = tree_digest(t)
                    assert tree_digest(t) == d0
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for th in threads:
        th.start()
    try:
        for i in range(6):
            ids = np.arange(10 * i, 10 * i + 10)
            eng.delete_batch(X[ids], ids)
            eng.insert_batch(X[ids] + 1e-3, ids + 1000)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=60)
    assert not any(th.is_alive() for th in threads) and not errs, errs
    assert eng.epochs.resident == [eng.epochs.epoch]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_bf16_scalars_and_tree(tmp_path):
    _, tree = _tree(100)
    state = {"tree": tree, "w": torch.randn(3, 5).to(torch.bfloat16),
             "step": torch.tensor(7, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 3, state, extra={"k": 1})
    out, man = restore_checkpoint(str(tmp_path), state)
    assert man["step"] == 3 and man["extra"] == {"k": 1}
    assert man["leaves"][-1]["dtype"] == "bfloat16"   # keys flatten sorted: "w" last
    assert torch.equal(out["w"], state["w"]) and out["w"].dtype == torch.bfloat16
    assert out["step"].shape == () and int(out["step"]) == 7
    assert tree_digest(out["tree"]) == tree_digest(tree)


def test_checkpoint_rotation_async_and_atomicity(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2, async_write=True, fsync_dir=True)
    for s in range(4):
        mgr.save(s, {"x": torch.full((4,), s)})
    mgr.wait()
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]
    os.makedirs(os.path.join(d, ".tmp-step_00000009.1"))   # a crashed writer
    out, man = mgr.restore_latest({"x": torch.zeros(4, dtype=torch.int64)})
    assert man["step"] == 3 and out["x"].tolist() == [3] * 4
    with pytest.raises(TypeError):
        save_checkpoint(d, 10, {"x": object()})
    assert mgr.latest_step() == 3


def test_engine_snapshot_plus_tail_replay_is_bitwise(tmp_path):
    X, tree = _tree(300)
    wal = WriteAheadLog(str(tmp_path / "wal"))
    ckpt = CheckpointManager(str(tmp_path / "ck"), async_write=False)
    eng = StreamingEngine(tree, wal=wal, ckpt=ckpt, max_batch=32)
    eng.delete_batch(X[:40], np.arange(40))
    eng.snapshot()
    eng.insert_batch(X[:40] + 1e-3, 900 + np.arange(40))
    eng.delete_batch(X[40:70], np.arange(40, 70))
    got = StreamingEngine.restore(str(tmp_path / "ck"), wal=wal, max_batch=32, device=DEV)
    assert tree_digest(got.tree) == tree_digest(eng.tree)


# ---------------------------------------------------------------------------
# rebalance
# ---------------------------------------------------------------------------
def _skewed_forest(n=1600, S=4, drop=300):
    X = clustered(n, dims=6, seed=4)
    trees = TD.build_forest_trees(X, S, capacity=8, device=DEV)
    b = MutationBatcher(trees[0], max_batch=64)
    ids = np.arange(0, n, S)[:drop]
    b.apply(np.full(len(ids), OP_DELETE, np.int32), X[ids], ids)
    trees[0] = b.tree
    return X, trees


def test_rebalance_trigger_rebuild_and_determinism():
    _, trees = _skewed_forest()
    stats = collect_stats(trees)
    assert stats.skew > 1.5 and needs_rebalance(stats)
    out, moved, params = rebalance_shards(trees, seed=3)
    again, moved2, _ = rebalance_shards(trees, seed=3)
    assert moved == moved2 > 0 and params == {"seed": 3, "moved": moved}
    assert tree_digest(out) == tree_digest(again)
    assert collect_stats(out).skew < 1.05 and collect_stats(out).total == stats.total
    for t in out:
        assert SMTreeEngine(t).validate()
    _, moved0, _ = rebalance_shards(out, seed=3)
    assert moved0 == 0


def test_plan_migration_matches_stop_world_and_is_bounded():
    _, trees = _skewed_forest()
    plan = plan_migration(trees, seed=1, step_objects=16)
    assert plan == plan_migration(trees, seed=1, step_objects=16)
    assert all(len(s.oids) <= 16 for s in plan.steps)
    assert MigrationPlan.from_params(json.loads(json.dumps(plan.to_params()))) == plan
    out, moved, _ = rebalance_shards(trees, seed=1)
    assert plan.total == moved
    where = {int(o): s for s, t in enumerate(out) for o in live_objects(t)[1]}
    for st in plan.steps:
        assert all(where[o] == st.receiver for o in st.oids)
    balanced, _, _ = rebalance_shards(trees, seed=1)
    assert plan_migration(balanced).steps == ()


def test_geometry_mismatch_and_free_ring_trigger():
    X = clustered(300, dims=6, seed=5)
    a = bulk_build(X, capacity=8, device=DEV)
    b = bulk_build(X, capacity=16, device=DEV)
    with pytest.raises(GeometryMismatch):
        check_geometry([a, b])
    _, trees = _skewed_forest(drop=40)
    stats = collect_stats(trees)
    assert not needs_rebalance(stats, max_skew=1.5)
    assert needs_rebalance(stats, max_skew=1.5, free_floor=0.99)


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------
@pytest.fixture
def obs_on():
    obs.reset()
    obs.enable()
    obs.set_trace_sampling(1)
    try:
        yield
    finally:
        obs.disable()
        obs.reset()
        obs.set_trace_sampling(obs.TRACE_SAMPLE_EVERY)


def test_instruments_spans_and_snapshot(obs_on):
    obs.counter("wal.appends_total").inc(3)
    obs.gauge("epoch.latest").set(4.0)
    h = obs.histogram("rebalance.step_pause_s")
    for v in (0.001, 0.002, 0.5):
        h.observe(v)
    with obs.span("mutation.apply", n=2) as s:
        with obs.span("mutation.publish"):
            pass
    recs = obs.RECORDER.records()
    assert obs.trace_connected(recs, s.trace_id)
    snap = obs.export.metrics_snapshot()
    m = snap["metrics"]
    assert m["wal.appends_total"] == 3 and m["epoch.latest"] == 4.0
    assert m["rebalance.step_pause_s.count"] == 3 and m["rebalance.step_pause_s.max"] == 0.5
    assert obs.export.missing_rows(snap, ["wal.", "epoch.", "replica."]) == ["replica."]
    with pytest.raises(OSError):          # nothing listens there
        obs.export.fetch_metrics(("127.0.0.1", 1), timeout_s=1.0)


def test_stream_plane_fills_the_stream_wal_and_epoch_rows(obs_on, tmp_path):
    X, tree = _tree(300)
    eng = StreamingEngine(tree, wal=WriteAheadLog(str(tmp_path / "wal")), max_batch=32)
    eng.delete_batch(X[:60], np.arange(60))
    names = [s["name"] for s in obs.RECORDER.spans()]
    assert names == ["mutation.wal_append", "mutation.apply", "mutation.publish"]
    res, pruned = knn(eng.tree, X[:4] + 1e-3, k=3, level_stats=True)
    obs.observe_query_result(res, pruned)
    snap = obs.export.metrics_snapshot()
    assert not obs.export.missing_rows(snap, ["stream.", "wal.", "epoch.", "descent."])
    m = snap["metrics"]
    assert m["stream.rows_total"] == 60 and m["descent.queries_total"] == 4
    assert m["stream.device_merges_total"] > 0


def test_disabled_obs_is_a_noop(tmp_path, monkeypatch):
    obs.disable()
    obs.reset()
    monkeypatch.setenv("REPRO_OBS_DUMP_DIR", str(tmp_path))
    obs.counter("x").inc()
    assert obs.span("y") is obs.NULL_SPAN and obs.record_fault("z") is None
    assert obs.REGISTRY.snapshot() == {"x": 0} and os.listdir(tmp_path) == []
