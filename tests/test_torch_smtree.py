"""Port parity: bulk build and the cohort kNN/range descent, bitwise against
the JAX package.

Build: the port's ``bulk_build`` against JAX ``bulk_build``, all 16 array
fields and the 5 meta fields.  Descent: one JAX-built tree carried into
the port with ``tree_from_numpy``; every QueryResult field and the
(by_bound, by_parent) level-stat stacks against JAX ``knn(impl="xla")``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401

from repro.core import smtree as J  # noqa: E402
from repro_torch.core import smtree as T  # noqa: E402
from repro_torch.core.convert import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.data.datagen import clustered, uniform  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

FIELDS = ("dists", "ids", "page_hits", "dist_evals", "overflow")


def jax_fields(t):
    return ({f: np.asarray(getattr(t, f)) for f in T.ARRAY_FIELDS},
            {f: getattr(t, f) for f in T.META_FIELDS})


def carry(jt):
    arrays, meta = jax_fields(jt)
    return tree_from_numpy(arrays, meta, "cpu")


def assert_same_result(jres, tres, msg):
    for f in FIELDS:
        want, got = np.asarray(getattr(jres, f)), getattr(tres, f).numpy()
        assert want.dtype == got.dtype, f"{msg}:{f} {want.dtype} vs {got.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=f"{msg}:{f}")


def both_knn(jt, tt, Q, msg, **kw):
    jr, (jbb, jbp) = J.knn(jt, Q, impl="xla", level_stats=True, **kw)
    tr, (tbb, tbp) = T.knn(tt, Q, level_stats=True, **kw)
    assert_same_result(jr, tr, msg)
    np.testing.assert_array_equal(tbb.numpy(), np.asarray(jbb), err_msg=f"{msg}:by_bound")
    np.testing.assert_array_equal(tbp.numpy(), np.asarray(jbp), err_msg=f"{msg}:by_parent")
    assert tbb.dtype == torch.int32 and tbp.dtype == torch.int32
    return tr


# --------------------------------------------------------------------------
# build
# --------------------------------------------------------------------------
@pytest.mark.parametrize("metric", ["d_inf", "l2", "l1"])
@pytest.mark.parametrize("n,capacity,seed", [(23, 32, 0), (700, 8, 1), (2500, 16, 2),
                                             (1200, 32, 3)])
def test_bulk_build_bitwise(metric, n, capacity, seed):
    X = clustered(n, dims=7 + seed, seed=seed)
    a, ma = jax_fields(J.bulk_build(X, capacity=capacity, metric=metric, seed=seed))
    b, mb = tree_to_numpy(T.bulk_build(X, capacity=capacity, metric=metric,
                                       seed=seed, device="cpu"))
    assert ma == mb
    for f in T.ARRAY_FIELDS:
        assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape, f
        np.testing.assert_array_equal(b[f], a[f], err_msg=f)


def test_convert_round_trip_and_dtypes():
    X = uniform(300, dims=5, seed=4)
    arrays, meta = jax_fields(J.bulk_build(X, capacity=8))
    t = tree_from_numpy(arrays, meta, "cpu")
    for f, dt in (("vecs", torch.float32), ("child", torch.int32),
                  ("valid", torch.bool), ("root", torch.int32)):
        assert getattr(t, f).dtype == dt, f
    assert t.root.shape == () and t.free_head.shape == ()
    back, meta2 = tree_to_numpy(t)
    assert meta2 == meta
    for f in T.ARRAY_FIELDS:
        np.testing.assert_array_equal(back[f], arrays[f])
    with pytest.raises(KeyError, match="free_list"):
        tree_from_numpy({k: v for k, v in arrays.items() if k != "free_list"}, meta, "cpu")


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.bulk_build(uniform(40, dims=3, seed=0), capacity=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.empty_tree(dim=3)
    assert T.bulk_build(uniform(40, dims=3, seed=0), capacity=8,
                        device="cpu").device.type == "cpu"


# --------------------------------------------------------------------------
# descent
# --------------------------------------------------------------------------
@pytest.mark.parametrize("metric", ["d_inf", "l2", "l1"])
def test_knn_bitwise_vs_jax(metric):
    X = clustered(1500, dims=8, seed=3)
    jt = J.bulk_build(X, capacity=16, metric=metric)
    tt = carry(jt)
    Q = np.vstack([uniform(12, dims=8, seed=4), X[:12] + 0.003]).astype(np.float32)
    for k, F, prune in ((1, 64, True), (8, 64, False), (8, 256, True)):
        both_knn(jt, tt, Q, f"{metric} k={k} F={F} prune={prune}",
                 k=k, max_frontier=F, parent_prune=prune)


def test_knn_k_exceeds_n():
    X = uniform(10, dims=5, seed=13)
    jt = J.bulk_build(X, capacity=8)
    Q = uniform(4, dims=5, seed=14)
    r = both_knn(jt, carry(jt), Q, "k>n", k=32, max_frontier=64)
    assert torch.isposinf(r.dists[:, 10:]).all() and (r.ids[:, 10:] == -1).all()


def test_duplicates_and_equidistant_ties():
    """Maximal tie stress: every point duplicated four times, and one-hot
    points all at the same distance from the origin.  Equal distances must
    come back in the reference's order (lowest candidate index first)."""
    rng = np.random.default_rng(11)
    base = rng.random((120, 6)).astype(np.float32)
    X = np.repeat(base, 4, axis=0)
    jt = J.bulk_build(X, capacity=8)
    both_knn(jt, carry(jt), base[:12] + 0.001, "duplicates", k=8, max_frontier=512)
    E = (np.eye(48, 48) * 0.7).astype(np.float32)
    jt = J.bulk_build(E, capacity=8)
    Q = np.vstack([np.zeros((1, 48), np.float32), E[:3]])
    both_knn(jt, carry(jt), Q, "equidistant", k=5, max_frontier=512)


def test_stable_selection_is_load_bearing(monkeypatch):
    """On the equidistant set a plain ``torch.topk`` selection returns the
    tied ids in another order than the reference's ``lax.top_k``; the
    stable sort must not."""
    E = (np.eye(48, 48) * 0.7).astype(np.float32)
    jt = J.bulk_build(E, capacity=8)
    Q = np.zeros((1, 48), np.float32)
    want = np.asarray(J.knn(jt, Q, k=5, max_frontier=512, impl="xla").ids)
    np.testing.assert_array_equal(T.knn(carry(jt), Q, k=5, max_frontier=512).ids.numpy(), want)

    def topk_select(x, n):
        return torch.topk(x, n, dim=1, largest=False)
    monkeypatch.setattr(T, "_smallest", topk_select)
    got = T.knn(carry(jt), Q, k=5, max_frontier=512).ids.numpy()
    assert not np.array_equal(got, want), "tie case no longer discriminates"


def test_range_search_bitwise_and_overflow_at_max_results():
    X = clustered(1500, dims=8, seed=5)
    for metric, cases in (("d_inf", ((0.0, True), (0.5, False))),
                          ("l2", ((0.05, True),))):
        jt = J.bulk_build(X, capacity=16, metric=metric)
        tt = carry(jt)
        Q = X[::100].copy()
        for r, prune in cases:
            jr = J.range_search(jt, Q, r, max_results=64, impl="xla", parent_prune=prune)
            tr = T.range_search(tt, Q, r, max_results=64, parent_prune=prune)
            assert_same_result(jr, tr, f"range {metric} r={r} prune={prune}")
    # exactly max_results in-radius points: the conservative flag is set
    rng = np.random.default_rng(17)
    m = 12
    X = np.vstack([(rng.random((m, 6)) * 0.02), rng.random((120, 6)) * 0.5 + 5.0]
                  ).astype(np.float32)
    jt = J.bulk_build(X, capacity=8)
    q = np.zeros((1, 6), np.float32)
    for mr in (m, m + 1):
        jr = J.range_search(jt, q, 0.1, max_results=mr, max_frontier=256, impl="xla")
        tr = T.range_search(carry(jt), q, 0.1, max_results=mr, max_frontier=256)
        assert_same_result(jr, tr, f"range exact capacity {mr}")
        assert bool(tr.overflow[0]) == (mr == m)


def test_per_query_radius_and_env_toggle(monkeypatch):
    X = clustered(600, dims=6, seed=6)
    jt = J.bulk_build(X, capacity=8)
    tt = carry(jt)
    Q = X[:8] + 0.01
    radii = np.linspace(0.0, 0.3, 8).astype(np.float32)
    assert_same_result(J.range_search(jt, Q, radii, max_results=32, impl="xla"),
                       T.range_search(tt, Q, radii, max_results=32), "per-query radius")
    monkeypatch.setenv("REPRO_PARENT_PRUNE", "0")
    off = T.knn(tt, Q, k=3)
    assert_same_result(J.knn(jt, Q, k=3, impl="xla", parent_prune=False), off, "env off")
    monkeypatch.setenv("REPRO_PARENT_PRUNE", "yes")
    with pytest.raises(ValueError, match="REPRO_PARENT_PRUNE"):
        T.knn(tt, Q, k=3)


def test_descent_on_single_leaf_tree():
    X = uniform(9, dims=4, seed=21)
    jt = J.bulk_build(X, capacity=32)
    assert int(jt.height) == 1
    both_knn(jt, carry(jt), X[:3], "single leaf", k=4, max_frontier=64)
