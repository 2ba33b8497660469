"""Port parity: the batched mutation scan (``apply_mutations`` with its row
lookups, ``extract_objects``, ``move_objects``) and the port's copy of the
paper's pointer-machine M-tree/SM-tree (``core/ref_impl.py``), against the
JAX package on the same numpy inputs.

Trees are compared field by field and by ``repro.stream.replica.tree_digest``
fed the port's numpy fields.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import ref_impl as JR  # noqa: E402
from repro.core import smtree as J  # noqa: E402
from repro.stream.replica import tree_digest  # noqa: E402
from repro_torch.core import ref_impl as TR  # noqa: E402
from repro_torch.core import smtree as T  # noqa: E402
from repro_torch.core.convert import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.data.datagen import clustered, uniform  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)


def jax_fields(t):
    return ({f: np.asarray(getattr(t, f)) for f in T.ARRAY_FIELDS},
            {f: getattr(t, f) for f in T.META_FIELDS})


def carry(jt):
    return tree_from_numpy(*jax_fields(jt), "cpu")


def digest_of(tt):
    arrays, meta = tree_to_numpy(tt)
    return tree_digest(types.SimpleNamespace(**arrays, **meta))


def assert_same_tree(jt, tt, msg=""):
    a, ma = jax_fields(jt)
    b, mb = tree_to_numpy(tt)
    assert ma == mb
    for f in T.ARRAY_FIELDS:
        assert a[f].dtype == b[f].dtype, f
        np.testing.assert_array_equal(b[f], a[f], err_msg=f"{msg}{f}")
    assert digest_of(tt) == tree_digest(jt)


def every_status_log(X, rng, n_new=60):
    """A conflict-free cohort with every status: deletes of held ids
    (enough from one leaf that the last ones underflow), deletes of absent
    ids, inserts of new ids (a pile on one point overflows its leaf), NOP
    rows and -1 pads, shuffled."""
    n, dim = X.shape
    held = rng.choice(n, 150, replace=False)
    new = n + 1000 + np.arange(n_new)
    pile = (X[3] + rng.normal(0, 1e-4, (n_new // 2, dim)))
    spread = rng.random((n_new - n_new // 2, dim))
    rows = ([(J.OP_DELETE, X[i], i) for i in held]
            + [(J.OP_DELETE, np.zeros(dim), n + 50_000 + j) for j in range(5)]
            + [(J.OP_INSERT, x, o) for x, o in zip(np.vstack([pile, spread]), new)]
            + [(J.OP_NOP, np.zeros(dim), n + 90_000 + j) for j in range(4)]
            + [(J.OP_NOP, np.zeros(dim), -1)] * 3)
    order = rng.permutation(len(rows))
    ops = np.array([rows[i][0] for i in order], np.int32)
    xs = np.array([rows[i][1] for i in order], np.float32)
    oids = np.array([rows[i][2] for i in order], np.int32)
    return ops, xs, oids


@pytest.mark.parametrize("metric,cap,seed", [("d_inf", 8, 0), ("l2", 12, 1),
                                             ("l1", 16, 2)])
def test_apply_mutations_bitwise_vs_jax(metric, cap, seed):
    X = clustered(2000, dims=8 + seed, seed=seed)
    jt = J.bulk_build(X, capacity=cap, metric=metric)
    tt = carry(jt)
    rng = np.random.default_rng(seed)
    seen = set()
    for rnd in range(2):                       # a second cohort on the result
        ops, xs, oids = every_status_log(X, rng)
        if rnd:
            oids = np.where(oids >= len(X) + 1000, oids + 100, oids).astype(np.int32)
        jt, jst = J.apply_mutations(jt, ops, xs, oids, splits=False, merges=False)
        out, tst = T.apply_mutations(tt, ops, xs, oids, splits=False, merges=False)
        assert out is tt                       # in place
        assert tst.dtype == torch.int32
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        assert_same_tree(jt, tt, f"{metric} round {rnd}: ")
        seen |= set(tst.tolist())
    assert seen == {T.ST_NOP, T.ST_APPLIED, T.ST_OVERFLOW, T.ST_UNDERFLOW,
                    T.ST_NOTFOUND}


def test_apply_mutations_statuses_cover_every_outcome():
    X = clustered(2000, dims=8, seed=0)
    tt = T.bulk_build(X, capacity=8, device="cpu")
    ops, xs, oids = every_status_log(X, np.random.default_rng(0))
    _, st = T.apply_mutations(tt, ops, xs, oids, splits=False, merges=False)
    assert set(st.tolist()) == {T.ST_NOP, T.ST_APPLIED, T.ST_OVERFLOW,
                                T.ST_UNDERFLOW, T.ST_NOTFOUND}
    assert (st[ops == T.OP_NOP] == T.ST_NOP).all()


def test_apply_mutations_matches_one_row_at_a_time_fast_paths():
    """The same log through ``insert_fast``/``delete_fast``, one row at a
    time, gives the same statuses and the same tree bytes."""
    X = clustered(1500, dims=6, seed=3)
    a = T.bulk_build(X, capacity=8, device="cpu")
    b = T.bulk_build(X, capacity=8, device="cpu")
    ops, xs, oids = every_status_log(X, np.random.default_rng(3))
    _, st = T.apply_mutations(a, ops, xs, oids, splits=False, merges=False)
    want = []
    for op, x, o in zip(ops, xs, oids):
        if op == T.OP_INSERT:
            _, fits, _ = T.insert_fast(b, x, int(o))
            want.append(T.ST_APPLIED if fits else T.ST_OVERFLOW)
        elif op == T.OP_DELETE:
            _, found, under, _ = T.delete_fast(b, x, int(o))
            want.append(T.ST_NOTFOUND if not found else
                        T.ST_UNDERFLOW if under else T.ST_APPLIED)
        else:
            want.append(T.ST_NOP)
    np.testing.assert_array_equal(st.numpy(), want)
    assert digest_of(a) == digest_of(b)


def test_locate_slots_first_hit_pads_and_empty():
    """Stored duplicates of one id: the lowest flat slot wins.  Negative
    requested ids never match, and an empty batch is fine."""
    X = uniform(200, dims=4, seed=2)
    ids = np.arange(200)
    ids[150:] = ids[:50]                       # each of 0..49 stored twice
    jt = J.bulk_build(X, ids=ids, capacity=8)
    tt = carry(jt)
    req = np.array([0, 49, 7, -1, 199, 123_456, 149], np.int32)
    for fn in ("_locate_slots", "_locate_oids"):
        want = getattr(J, fn)(jt, jnp.asarray(req))
        got = getattr(T, fn)(tt, req)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=fn)
        assert got[0].dtype == torch.int32
    first, found = T._locate_slots(tt, np.zeros((0,), np.int32))
    assert first.shape == (0,) and found.shape == (0,) and found.dtype == torch.bool
    vecs, found = T.extract_objects(tt, np.zeros((0,), np.int32))
    assert vecs.shape == (0, 4) and found.shape == (0,)


def test_extract_and_move_objects_bitwise_with_negative_zero():
    X = clustered(1200, dims=6, seed=7)
    X[10, :2] = -0.0
    donor_j = J.bulk_build(X[:800], ids=np.arange(800), capacity=8)
    recv_j = J.bulk_build(X[800:], ids=np.arange(800, 1200), capacity=8)
    donor_t, recv_t = carry(donor_j), carry(recv_j)
    req = np.array([10, 11, 12, 900, -1, 5000, 799], np.int32)
    wv, wf = J.extract_objects(donor_j, req)
    gv, gf = T.extract_objects(donor_t, req)
    assert gv.numpy().tobytes() == np.asarray(wv).tobytes()
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    assert np.signbit(gv[0, :2].numpy()).all()       # a select keeps -0.0
    # a move: ids absent from the donor and pads are not moved
    move = np.concatenate([np.arange(10, 40), [900, 5000, -1]]).astype(np.int32)
    donor_j, recv_j, wm = J.move_objects(donor_j, recv_j, move, splits=False,
                                         merges=False)
    d_out, r_out, gm = T.move_objects(donor_t, recv_t, move, splits=False, merges=False)
    assert d_out is donor_t and r_out is recv_t
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert gm[:30].any() and not gm[30:].any()
    assert_same_tree(donor_j, donor_t, "donor ")
    assert_same_tree(recv_j, recv_t, "receiver ")


# --------------------------------------------------------------------------
# the paper's pointer-machine trees
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cls", ["MTree", "SMTree"])
def test_ref_impl_copy_matches_the_reference(cls):
    X = clustered(700, dims=10, seed=5)
    trees = [getattr(mod, cls)(dim=10, capacity=8, n_dims=10) for mod in (JR, TR)]
    for t in trees:
        for i, x in enumerate(X):
            t.insert(x, i)
    rng = np.random.default_rng(6)
    Q = X[rng.integers(0, len(X), 12)] + rng.normal(0, 0.02, (12, 10)).astype(np.float32)
    for q in Q:
        outs = []
        for t in trees:
            t.reset_counters()
            knn = t.knn_query(q, 5)
            rng_q = sorted(t.range_query(q, 0.15))
            best = t.knn_query_bestfirst(q, 3)
            outs.append((knn, rng_q, best, t.ios, t.dist_calcs))
        assert outs[0] == outs[1]
    if cls == "SMTree":
        for t in trees:
            for i in range(0, 700, 4):
                assert t.delete(X[i], i)
            t.validate(check_sm_invariant=True, check_min_fill=True)
    a, b = (sorted((i, v.tobytes()) for i, v in t.all_objects()) for t in trees)
    assert a == b
    # two classes of one shape: compare the fields
    assert vars(trees[0].stats()) == vars(trees[1].stats())
    assert trees[0].height == trees[1].height
