"""The port's serving front-end (``repro_torch.serve.frontend``) on the
CPU: the reference's ``test_serve_frontend.py`` cases (deadline-or-batch-
full dispatch, pad-to-width, epoch tagging, the mutation scheduler, the
overload policies, the kNN-LM store's published-epoch resync), and per
ticket ``(dists, ids)`` equal to the reference ``ServeFrontend``'s over
equal trees (a JAX-built tree carried across by ``core/convert.py``).

Every test that starts the front-end's threads stops them in a ``with``
or ``finally``; none asserts on anything a sleep decides.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.stream as JS  # noqa: E402
from repro.core import smtree as J  # noqa: E402
from repro.serve import frontend as JF  # noqa: E402
from repro_torch.core import smtree as T  # noqa: E402
from repro_torch.core.convert import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.core.metric import pairwise  # noqa: E402
from repro_torch.serve.frontend import (FrontendConfig, QueueFull,  # noqa: E402
                                        ServeFrontend, pinned_knn)
from repro_torch.stream import StreamingEngine  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

N, DIM = 384, 6


def _engine(seed=0, n=N):
    X = np.random.default_rng(seed).random((n, DIM)).astype(np.float32)
    return StreamingEngine(T.bulk_build(X, capacity=8, device="cpu")), X


@pytest.mark.timeout(60)
def test_full_cohort_dispatches_immediately():
    eng, X = _engine()
    Q = np.random.default_rng(1).random((8, DIM)).astype(np.float32)
    cfg = FrontendConfig(cohort_width=8, slo_ms=10_000.0, k=3, max_frontier=256)
    with ServeFrontend(eng, cfg) as fe:
        d, ids = fe.knn(Q)     # exactly one full-width cohort
    assert d.device.type == "cpu" and ids.dtype == torch.int32
    want = np.sort(pairwise(eng.tree.metric, Q, X), axis=1)[:, :3]
    np.testing.assert_allclose(d.numpy(), want, atol=1e-5)
    assert fe.stats.n_cohorts == 1
    assert fe.stats.n_full_dispatch == 1
    assert fe.stats.n_deadline_dispatch == 0
    assert fe.stats.mean_fill == 8


@pytest.mark.timeout(60)
def test_partial_cohort_ships_at_deadline():
    eng, X = _engine()
    Q = np.random.default_rng(2).random((3, DIM)).astype(np.float32)
    cfg = FrontendConfig(cohort_width=8, slo_ms=40.0, k=2, max_frontier=256)
    with ServeFrontend(eng, cfg) as fe:
        tickets = fe.submit_many(Q)        # 3 < width: only the SLO fires
        out = [t.result(30) for t in tickets]
    d = np.stack([d.numpy() for d, _ in out])
    want = np.sort(pairwise(eng.tree.metric, Q, X), axis=1)[:, :2]
    np.testing.assert_allclose(d, want, atol=1e-5)   # pad rows discarded
    assert fe.stats.n_deadline_dispatch >= 1
    assert fe.stats.n_queries == 3


@pytest.mark.timeout(60)
def test_tickets_record_their_epoch_and_see_publishes():
    eng, X = _engine()
    cfg = FrontendConfig(cohort_width=1, slo_ms=5.0, k=1, max_frontier=256)
    newpt = np.full((1, DIM), 0.5, np.float32)
    with ServeFrontend(eng, cfg) as fe:
        tk0 = fe.submit(newpt[0])
        tk0.result(30)
        assert tk0.epoch == 0
        mt = fe.submit_mutations(np.full(1, T.OP_INSERT, np.int32), newpt,
                                 np.array([N], np.int32))
        res = mt.result(30)
        assert (res.statuses == T.ST_APPLIED).all()
        tk1 = fe.submit(newpt[0])
        d, ids = tk1.result(30)
        assert tk1.epoch == 1
        assert ids[0] == N and d[0] <= 1e-6   # the insert is visible now


@pytest.mark.timeout(60)
def test_cohort_error_fails_its_tickets():
    eng, _ = _engine()

    def bad_knn(pinned, q):
        raise RuntimeError("descent exploded")

    cfg = FrontendConfig(cohort_width=1, slo_ms=5.0)
    with ServeFrontend(eng, cfg, knn_fn=bad_knn) as fe:
        tk = fe.submit(np.zeros(DIM, np.float32))
        with pytest.raises(RuntimeError, match="descent exploded"):
            tk.result(30)


@pytest.mark.timeout(60)
def test_stop_drains_and_rejects_new_work():
    eng, _ = _engine()
    fe = ServeFrontend(eng, FrontendConfig(cohort_width=4, slo_ms=20.0, k=1)).start()
    try:
        tickets = fe.submit_many(np.zeros((6, DIM), np.float32))
    finally:
        fe.stop()                   # drain=True: everything admitted serves
    assert all(t.done() and t.err is None for t in tickets)
    with pytest.raises(RuntimeError):
        fe.submit(np.zeros(DIM, np.float32))
    with pytest.raises(RuntimeError):
        fe.submit_mutations(np.zeros(1, np.int32), np.zeros((1, DIM)),
                            np.zeros(1, np.int32))


def test_pinned_knn_forest_merge():
    from repro_torch.core.distributed import build_forest_trees
    X = np.random.default_rng(5).random((400, DIM)).astype(np.float32)
    shards = tuple(build_forest_trees(X, 2, capacity=8, device="cpu"))
    d, ids = pinned_knn(shards, torch.from_numpy(X[:10] + 0.001), k=3, max_frontier=256)
    want = np.sort(pairwise(shards[0].metric, X[:10] + 0.001, X), axis=1)[:, :3]
    np.testing.assert_allclose(d.numpy(), want, atol=1e-5)


@pytest.mark.timeout(60)
def test_shed_policy_raises_queue_full_with_hint():
    eng, X = _engine()
    # width never fills and the SLO is huge, so admitted queries park
    cfg = FrontendConfig(cohort_width=64, slo_ms=60_000.0, k=2,
                         max_frontier=256, queue_cap=3, overload="shed")
    fe = ServeFrontend(eng, cfg).start()
    try:
        q = np.random.default_rng(7).random(DIM).astype(np.float32)
        tickets = [fe.submit(q) for _ in range(3)]
        with pytest.raises(QueueFull) as ei:
            fe.submit(q)
        assert ei.value.retry_after_s > 0       # actionable hint
        assert fe.stats.n_shed == 1
        assert fe.stats.snapshot()["queue_depth"] == 3
        assert fe.stats.snapshot()["n_shed"] == 1
    finally:
        fe.stop(drain=False)
    assert all(t.done() for t in tickets)       # failed by stop, not lost


def test_shed_policy_caps_mutation_queue():
    eng, X = _engine()
    cfg = FrontendConfig(cohort_width=4, slo_ms=5.0, mutation_queue_cap=2,
                         overload="shed")
    fe = ServeFrontend(eng, cfg)
    fe._running = True              # queues only: workers never drain
    ops = np.full(1, T.OP_NOP, np.int32)
    xs = np.zeros((1, DIM), np.float32)
    oid = np.array([0], np.int32)
    fe.submit_mutations(ops, xs, oid)
    fe.submit_mutations(ops, xs, oid)
    with pytest.raises(QueueFull):
        fe.submit_mutations(ops, xs, oid)
    assert fe.stats.snapshot()["mutation_queue_depth"] == 2
    fe._running = False


@pytest.mark.timeout(60)
def test_block_policy_unchanged_under_cap():
    """Default policy still blocks (and then succeeds) rather than shed."""
    eng, X = _engine()
    cfg = FrontendConfig(cohort_width=2, slo_ms=5.0, k=2, max_frontier=256, queue_cap=2)
    with ServeFrontend(eng, cfg) as fe:
        Q = np.random.default_rng(8).random((10, DIM)).astype(np.float32)
        tickets = fe.submit_many(Q)     # > cap: submit blocks, never raises
        for t in tickets:
            t.result(30)
    assert fe.stats.n_queries == 10
    assert fe.stats.n_shed == 0


@pytest.mark.timeout(60)
def test_cohorts_behind_a_batch_are_timed_apart():
    """Every cohort's service time lands in exactly one of the two
    histograms: beside a batch apply, or alone."""
    eng, X = _engine(seed=3)
    cfg = FrontendConfig(cohort_width=4, slo_ms=2.0, k=2, max_frontier=256)
    rng = np.random.default_rng(4)
    with ServeFrontend(eng, cfg) as fe:
        for i in range(3):
            fe.submit_mutations(np.full(8, T.OP_INSERT, np.int32),
                                rng.random((8, DIM)).astype(np.float32),
                                np.arange(N + 8 * i, N + 8 * i + 8, dtype=np.int32))
            fe.knn(rng.random((6, DIM)).astype(np.float32))
    s = fe.stats
    assert s.cohort_hist.count + s.behind_apply_hist.count == s.n_cohorts > 0
    snap = s.snapshot()
    assert snap["n_cohorts_behind_apply"] == s.behind_apply_hist.count
    assert s.n_mutation_batches == 3


# -- per-ticket parity with the reference front-end ------------------------

@pytest.mark.timeout(120)
@pytest.mark.parametrize("width,k,F", [(8, 3, 256), (5, 4, 8)])
def test_tickets_equal_the_reference_frontend(width, k, F):
    """The same JAX-built tree behind both front-ends, the same queries,
    then the same mutation batch: every ticket's (dists, ids) and epoch
    equal the reference's (a row's result does not depend on the cohort it
    lands in; F=8 truncates frontiers on some rows)."""
    rng = np.random.default_rng(width)
    X = rng.random((N, DIM)).astype(np.float32)
    jtree = J.bulk_build(X, capacity=8)
    ttree = tree_from_numpy(*_jax_tree_numpy(jtree), "cpu")
    Q = rng.random((13, DIM)).astype(np.float32)
    mut = (np.full(10, T.OP_INSERT, np.int32), rng.random((10, DIM)).astype(np.float32),
           np.arange(N, N + 10, dtype=np.int32))
    out = {}
    for name, mod, eng in (("port", None, StreamingEngine(ttree)),
                           ("reference", JF, JS.StreamingEngine(jtree))):
        cfg_cls = FrontendConfig if mod is None else mod.FrontendConfig
        fe_cls = ServeFrontend if mod is None else mod.ServeFrontend
        cfg = cfg_cls(cohort_width=width, slo_ms=5.0, k=k, max_frontier=F)
        rows = []
        with fe_cls(eng, cfg) as fe:
            for tk in fe.submit_many(Q):
                d, i = tk.result(60)
                rows.append((np.asarray(d), np.asarray(i), tk.epoch))
            fe.submit_mutations(*mut).result(60)
            for tk in fe.submit_many(Q):
                d, i = tk.result(60)
                rows.append((np.asarray(d), np.asarray(i), tk.epoch))
        out[name] = rows
    assert len(out["port"]) == len(out["reference"]) == 26
    for (dp, ip, ep), (dr, ir, er) in zip(out["port"], out["reference"]):
        np.testing.assert_array_equal(dp, dr)
        np.testing.assert_array_equal(ip, ir)
        assert ep == er
    assert {e for *_, e in out["port"]} == {0, 1}


def _jax_tree_numpy(jtree):
    from repro_torch.core.smtree import ARRAY_FIELDS, META_FIELDS
    arrays = {f: np.asarray(getattr(jtree, f)) for f in ARRAY_FIELDS}
    meta = {f: getattr(jtree, f) for f in META_FIELDS}
    return arrays, meta


def test_convert_round_trip_of_the_served_tree():
    X = np.random.default_rng(9).random((200, DIM)).astype(np.float32)
    jtree = J.bulk_build(X, capacity=8)
    t = tree_from_numpy(*_jax_tree_numpy(jtree), "cpu")
    arrays, meta = tree_to_numpy(t)
    for f, a in arrays.items():
        np.testing.assert_array_equal(a, np.asarray(getattr(jtree, f)))


# -- KnnLmDatastore: engine reads come from the published epoch ------------

def _store():
    from repro_torch.serve.knnlm import KnnLmConfig, KnnLmDatastore
    rng = np.random.default_rng(7)
    keys = rng.random((256, DIM)).astype(np.float32)
    vals = rng.integers(0, 50, 256).astype(np.int32)
    store = KnnLmDatastore(KnnLmConfig(k=3, capacity=8, metric="l2"), DIM, device="cpu")
    store.build(keys, vals)
    return store, rng


def test_knnlm_sync_uses_published_epoch_not_working_tree():
    store, rng = _store()
    store.enable_stream()
    published = store.stream.epochs.current()[1]
    store.stream.batcher.tree = T.bulk_build(
        rng.random((64, DIM)).astype(np.float32), capacity=8, device="cpu")
    assert store.stream.tree is not published
    store._sync_engine_tree()
    assert store.engine.tree is published


@pytest.mark.timeout(60)
def test_knnlm_frontend_roundtrip():
    store, rng = _store()
    store.enable_stream()
    store.enable_frontend(cohort_width=4, slo_ms=20.0)
    try:
        h = rng.random((4, DIM)).astype(np.float32)
        logp = store.knn_logits(torch.from_numpy(h), 50)
        assert logp.shape == (4, 50)
        assert bool(torch.isfinite(logp).all())
        oids = store.add_batch(rng.random((4, DIM)).astype(np.float32),
                               rng.integers(0, 50, 4).astype(np.int32))
        assert store.evict_batch(oids) == 4    # rows *submitted*
        store.frontend.drain(timeout=60)
        assert store.frontend.stats.n_mutation_batches == 2
        store._sync_engine_tree()
        assert store.engine.tree is store.stream.epochs.current()[1]
    finally:
        store.close_frontend()
    assert store.frontend is None


@pytest.mark.timeout(120)
def test_many_clients_lose_no_ticket_and_no_count():
    """16 client threads (more than this machine's cores) against one
    front-end, the interpreter switching threads every 10 us: every ticket
    is served with its own row's answer, and the counters updated under
    the front-end's lock add up."""
    import sys
    import threading
    eng, X = _engine(seed=11)
    Q = np.random.default_rng(12).random((16 * 12, DIM)).astype(np.float32)
    want = np.sort(pairwise(eng.tree.metric, Q, X), axis=1)[:, :2]
    got, errors = {}, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ServeFrontend(eng, FrontendConfig(cohort_width=8, slo_ms=1.0, k=2,
                                               max_frontier=256)) as fe:
            def client(c):
                try:
                    for j in range(12):
                        r = c * 12 + j
                        got[r] = fe.submit(Q[r]).result(60)[0].numpy()
                except Exception as exc:  # noqa: BLE001 — re-raised below
                    errors.append(exc)
            threads = [threading.Thread(target=client, args=(c,)) for c in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=90)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[0]
    np.testing.assert_allclose(np.stack([got[r] for r in range(len(Q))]), want, atol=1e-5)
    s = fe.stats
    assert s.n_queries == len(Q) == s.fill_sum
    assert s.n_full_dispatch + s.n_deadline_dispatch == s.n_cohorts
    assert s.latency_hist.count == len(Q)
    assert s.cohort_hist.count + s.behind_apply_hist.count == s.n_cohorts
