"""Port parity: the Insert/Delete engine against the JAX engine, bitwise.

The same op log (splits and merges included) runs on
``repro.core.engine.SMTreeEngine`` and the port's engine; after every op all
16 array fields and the meta fields must be equal, ``validate()`` must pass,
and ``pdist == d(vec, routing vec)`` must hold bitwise (the invariant the
parent-distance filter rides on; cf. tests/test_pdist_invariant.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401

from repro.core.engine import SMTreeEngine as JaxEngine  # noqa: E402
from repro_torch.core import smtree as T  # noqa: E402
from repro_torch.core.convert import tree_to_numpy  # noqa: E402
from repro_torch.core.engine import SMTreeEngine  # noqa: E402
from repro_torch.core.metric import get_metric  # noqa: E402
from repro_torch.data.datagen import clustered, uniform  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

METRICS = ["d_inf", "l2", "l1"]


def assert_trees_equal(jeng, teng, msg):
    arrays, meta = tree_to_numpy(teng.tree)
    for f in T.ARRAY_FIELDS:
        want = np.asarray(getattr(jeng.tree, f))
        assert want.dtype == arrays[f].dtype, f"{msg}:{f}"
        np.testing.assert_array_equal(arrays[f], want, err_msg=f"{msg}:{f}")
    for f in T.META_FIELDS:
        assert meta[f] == getattr(jeng.tree, f), f"{msg}:{f}"


def assert_pdist_exact(tree, msg=""):
    a, _ = tree_to_numpy(tree)
    N = a["alive"].shape[0]
    root = int(a["root"])
    has_parent = a["alive"] & (np.arange(N) != root) & (a["parent"] >= 0)
    pn = np.where(has_parent, a["parent"], 0)
    ps = np.where(has_parent, np.maximum(a["pslot"], 0), 0)
    routing = a["vecs"][pn, ps]
    mask = a["valid"] & has_parent[:, None]
    fn = get_metric(tree.metric)
    want_np = fn(a["vecs"], routing[:, None, :])
    want_t = fn(torch.from_numpy(a["vecs"]), torch.from_numpy(routing)[:, None, :]).numpy()
    np.testing.assert_array_equal(a["pdist"][mask], want_np[mask], err_msg=msg)
    np.testing.assert_array_equal(a["pdist"][mask], want_t[mask], err_msg=msg)


@pytest.mark.parametrize("metric", METRICS)
def test_op_log_bitwise_vs_jax(metric):
    X = uniform(330, dims=6, seed=3 + len(metric))
    kw = dict(ids=np.arange(120), capacity=4, metric=metric, slack=1.2)
    jeng = JaxEngine.build(X[:120], **kw)
    teng = SMTreeEngine.build(X[:120], device="cpu", **kw)
    assert_trees_equal(jeng, teng, "build")
    rng = np.random.default_rng(5)
    live, nxt = set(range(120)), 120
    grew = shrank = 0
    for step in range(70):
        before = teng.tree.n_free_nodes
        if live and rng.random() < 0.45:
            oid = int(rng.choice(sorted(live)))
            assert jeng.delete(X[oid], oid)
            assert teng.delete(X[oid], oid)
            live.discard(oid)
        else:
            jeng.insert(X[nxt], nxt)
            teng.insert(X[nxt], nxt)
            live.add(nxt)
            nxt += 1
        grew += teng.tree.n_free_nodes < before
        shrank += teng.tree.n_free_nodes > before
        assert_trees_equal(jeng, teng, f"{metric} step {step}")
    assert grew and shrank, "the op log must split and merge"
    assert teng.n_objects == len(live) == jeng.n_objects
    assert_pdist_exact(teng.tree, metric)
    teng.validate()


def test_grow_from_empty_and_delete_semantics():
    X = clustered(60, dims=5, seed=8)
    jeng = JaxEngine.empty(dim=5, capacity=4, max_nodes=8)
    teng = SMTreeEngine.empty(dim=5, capacity=4, max_nodes=8, device="cpu")
    for i, x in enumerate(X):
        jeng.insert(x, i)
        teng.insert(x, i)
    assert_trees_equal(jeng, teng, "grown")
    assert teng.tree.max_nodes > 8          # the host view grew the arrays
    assert not teng.delete(X[0], 10_000) and not jeng.delete(X[0], 10_000)
    assert not teng.delete(X[0], -1)        # the pad sentinel never matches
    for i in range(0, 60, 2):
        assert jeng.delete(X[i], i) and teng.delete(X[i], i)
    assert_trees_equal(jeng, teng, "drained")
    assert_pdist_exact(teng.tree, "drained")
    teng.validate()
    Q = X[:6] + 0.01
    a, b = jeng.knn(Q, k=3, max_frontier=128, impl="xla"), teng.knn(Q, k=3, max_frontier=128)
    np.testing.assert_array_equal(b.dists.numpy(), np.asarray(a.dists))
    np.testing.assert_array_equal(b.ids.numpy(), np.asarray(a.ids))


def test_fast_paths_decline_without_writing():
    """A full leaf makes insert_fast decline and an underflowing leaf makes
    delete_fast decline; either way the in-place fast path writes nothing."""
    X = uniform(200, dims=4, seed=9)
    eng = SMTreeEngine.build(X, capacity=8, device="cpu")
    t = eng.tree
    x = X[0]
    for j in range(16):                 # copies of one point fill one leaf
        before, _ = tree_to_numpy(t)
        t, fits, _ = T.insert_fast(t, x, 1000 + j)
        if not fits:
            break
    assert not fits
    after, _ = tree_to_numpy(t)
    for f in T.ARRAY_FIELDS:
        np.testing.assert_array_equal(after[f], before[f], err_msg=f"insert:{f}")
    a, _ = tree_to_numpy(t)
    leaf = next(n for n in range(t.max_nodes) if a["alive"][n] and a["is_leaf"][n]
                and n != int(a["root"]) and a["count"][n] > t.min_fill
                and a["oid"][n, :a["count"][n]].max() < len(X))
    oids = [int(o) for o in a["oid"][leaf, :a["count"][leaf]]]
    for oid in oids[:len(oids) - t.min_fill]:       # thin it to min_fill
        t, found, underflow, _ = T.delete_fast(t, X[oid], oid)
        assert found and not underflow
    before, _ = tree_to_numpy(t)
    oid = int(before["oid"][leaf, 0])
    t, found, underflow, got_leaf = T.delete_fast(t, X[oid], oid)
    assert found and underflow and got_leaf == leaf
    after, _ = tree_to_numpy(t)
    for f in T.ARRAY_FIELDS:
        np.testing.assert_array_equal(after[f], before[f], err_msg=f"delete:{f}")
