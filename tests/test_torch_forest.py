"""Port parity: the SM-forest (stack, forest kNN with its k-way merge, the
sharded scan, the mutation fronts) and the per-query engine, bitwise
against the JAX package.

The JAX forest runs sharded over 4 host devices, so its side runs in one
subprocess for the whole module (the ``ref`` fixture): the inputs go to it as an
``.npz`` and its results come back as one.  The per-query engine and the
host-side stack/unstack are compared in this process.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401

from repro.core import distributed as JD  # noqa: E402
from repro.core import smtree as J  # noqa: E402
from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.core import smtree as T  # noqa: E402
from repro_torch.core.convert import (forest_from_numpy,  # noqa: E402
                                      tree_from_numpy, tree_to_numpy)
from repro_torch.core.engine import SMTreeEngine  # noqa: E402
from repro_torch.data.datagen import clustered, uniform  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
S = 4
FIELDS = ("dists", "ids", "page_hits", "dist_evals", "overflow")
# unequal shards: heights 5, 4, 2, 4 at capacity 8
UNEQUAL_SIZES = (1500, 200, 30, 700)
EQ_KNN = {"eq_F256_on": (5, 256, True), "eq_F256_off": (5, 256, False),
          "eq_F2_on": (5, 2, True), "eq_k1_F16_on": (1, 16, True)}
UNEQ_KNN = {"uneq_F3": (4, 3, True), "uneq_F64": (4, 64, True),
            "uneq_F64_off": (4, 64, False)}


def _inputs():
    rng = np.random.default_rng(0)
    X = rng.random((3000, 8)).astype(np.float32)
    X[5, :3] = -0.0                      # a stored -0.0 for the extract front
    Q = np.vstack([X[:24] + rng.normal(0, 0.02, (24, 8)),
                   rng.random((8, 8))]).astype(np.float32)
    XU = clustered(sum(UNEQUAL_SIZES), dims=10, seed=1)
    QU = (XU[::97][:20] + 0.01).astype(np.float32)
    # the delete front: ids 0..599, an absent id and a pad
    del_oids = np.concatenate([np.arange(600), [99_999, -1]]).astype(np.int32)
    del_xs = np.vstack([X[:600], np.zeros((2, 8), np.float32)])
    # the apply front: every status.  Deletes of held ids (one underflows),
    # absent ids, inserts of new ids (a pile on one point overflows its
    # leaf), NOPs and rows no shard owns
    new = 10_000 + np.arange(40)
    ins_xs = (X[7] + rng.normal(0, 1e-4, (40, 8))).astype(np.float32)
    ops = np.concatenate([np.full(300, J.OP_DELETE), np.full(3, J.OP_DELETE),
                          np.full(40, J.OP_INSERT), np.full(4, J.OP_NOP),
                          np.full(3, J.OP_INSERT)]).astype(np.int32)
    oids = np.concatenate([np.arange(1000, 1300), [50_001, 50_002, 50_003], new,
                           [60_001, 60_002, 60_003, 60_004], [70_001, 70_002, 70_003]]
                          ).astype(np.int32)
    xs = np.vstack([X[1000:1300], np.zeros((3, 8)), ins_xs, np.zeros((4, 8)),
                    rng.random((3, 8))]).astype(np.float32)
    owner = (oids % S).astype(np.int32)
    owner[-3:] = [-1, S, -1]             # owned by no shard: ST_NOP
    # the extract front: the -0.0 row, held ids, a wrong owner, absent, pads
    ex_oids = np.array([5, 6, 7, 11, 2999, 12, 77_777, -1], np.int32)
    ex_owner = np.array([1, 2, 3, 3, 3, 1, 0, 0], np.int32)
    # the unequal forest's split front: piles of six on four leaves of
    # shard 2 (a root of six entries at capacity 8: it overflows and a new
    # root grows inside the stack) and one pile on shard 0
    trees = _unequal_trees(T, XU, device="cpu")
    lo2 = sum(UNEQUAL_SIZES[:2])
    t2 = trees[2]
    leaves2 = [n for n in range(t2.max_nodes) if bool(t2.alive[n] & t2.is_leaf[n])]
    centres = [int(t2.oid[n, 0]) for n in leaves2[:4]] + [0]
    g_xs = np.vstack([XU[c] + rng.normal(0, 1e-3, (6, 10)) for c in centres])
    g_oids = (80_000 + np.arange(len(g_xs))).astype(np.int32)
    g_owner = np.array([2] * 24 + [0] * 6, np.int32)
    # the merge front: all but three of shard 2's objects (cascading merges
    # down to a root collapse inside the stack) and a fifth of shard 3's
    lo3 = lo2 + UNEQUAL_SIZES[2]
    c_oids = np.concatenate([np.arange(lo2, lo3 - 3),
                             np.arange(lo3, lo3 + UNEQUAL_SIZES[3], 5)]).astype(np.int32)
    c_owner = np.where(c_oids < lo3, 2, 3).astype(np.int32)
    return dict(X=X, Q=Q, XU=XU, QU=QU, del_oids=del_oids, del_xs=del_xs,
                ops=ops, oids=oids, xs=xs, owner=owner, ex_oids=ex_oids,
                ex_owner=ex_owner, g_ops=np.full(30, J.OP_INSERT, np.int32),
                g_xs=g_xs.astype(np.float32), g_oids=g_oids, g_owner=g_owner,
                c_ops=np.full(len(c_oids), J.OP_DELETE, np.int32),
                c_xs=XU[c_oids], c_oids=c_oids, c_owner=c_owner)


def _escalation_rows(st, ops, status, op):
    """The compacted rows of one escalation kind, in log order."""
    return np.nonzero((np.asarray(st) == status) & (np.asarray(ops) == op))[0]


def _unequal_trees(mod, XU, **kw):
    """Bulk-built trees over contiguous slices of XU (global ids)."""
    out, lo = [], 0
    for s, n in enumerate(UNEQUAL_SIZES):
        idx = np.arange(lo, lo + n)
        out.append(mod.bulk_build(XU[idx], ids=idx, capacity=8, seed=s, **kw))
        lo += n
    return out


_WORKER = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import distributed as D, smtree as J
from repro.dist.sharding import use_mesh

FIELDS = {fields!r}
inp = dict(np.load(sys.argv[1]))
out = {{}}
mesh = jax.make_mesh((4,), ("model",))

def save(prefix, forest):
    for f in FIELDS:
        out[prefix + f] = np.asarray(getattr(forest, f))

def fresh():
    return D.build_forest(inp["X"], mesh, capacity=16)[0]

trees, lo = [], 0
for s, n in enumerate({sizes!r}):
    idx = np.arange(lo, lo + n)
    trees.append(J.bulk_build(inp["XU"][idx], ids=idx, capacity=8, seed=s))
    lo += n
uneq = D.place_forest(D.stack_trees(trees), mesh)
with use_mesh(mesh):
    forest = fresh()
    save("eq_forest_", forest)
    save("uneq_forest_", uneq)
    out["uneq_static_height"] = np.int32(-1 if D.common_static_height(uneq) is None
                                         else D.common_static_height(uneq))
    for name, (k, F, pp) in {eq_knn!r}.items():
        d, i = D.forest_knn(forest, mesh, jnp.asarray(inp["Q"]), k=k,
                            max_frontier=F, parent_prune=pp)
        out[name + "_d"], out[name + "_i"] = np.asarray(d), np.asarray(i)
    for name, (k, F, pp) in {uneq_knn!r}.items():
        d, i = D.forest_knn(uneq, mesh, jnp.asarray(inp["QU"]), k=k,
                            max_frontier=F, parent_prune=pp)
        out[name + "_d"], out[name + "_i"] = np.asarray(d), np.asarray(i)
    Xs = jax.device_put(jnp.asarray(inp["X"]), NamedSharding(mesh, P("model")))
    for k in (1, 6):
        d, i = D.brute_force_knn(Xs, mesh, jnp.asarray(inp["Q"]), k=k)
        out[f"brute_k{{k}}_d"], out[f"brute_k{{k}}_i"] = np.asarray(d), np.asarray(i)
    f2, found = D.forest_delete(fresh(), mesh, jnp.asarray(inp["del_xs"]),
                                jnp.asarray(inp["del_oids"]))
    out["del_found"] = np.asarray(found)
    save("del_forest_", f2)
    f3, st = D.forest_apply_mutations(fresh(), mesh, inp["ops"], inp["xs"],
                                      inp["oids"], inp["owner"], validate=True)
    out["apply_status"] = np.asarray(st)
    save("apply_forest_", f3)
    v, f = D.forest_extract_objects(forest, mesh, inp["ex_oids"], inp["ex_owner"])
    out["ex_vecs"], out["ex_found"] = np.asarray(v), np.asarray(f)

    # the fast scan, then the split front on its overflow rows, then the
    # merge front on its underflow rows (none overflow by then)
    def fronts(name, f, p):
        f, st = D.forest_apply_mutations(f, mesh, inp[p + "ops"], inp[p + "xs"],
                                         inp[p + "oids"], inp[p + "owner"])
        st = np.asarray(st)
        out[name + "_scan_status"] = st
        for kind, code, op in (("split", J.ST_OVERFLOW, J.OP_INSERT),
                               ("merge", J.ST_UNDERFLOW, J.OP_DELETE)):
            idx = np.nonzero((st == code) & (inp[p + "ops"] == op))[0]
            if not len(idx):
                continue
            args = [inp[p + k][idx] for k in ("ops", "xs", "oids", "owner")]
            if kind == "split":
                f, s2 = D.forest_apply_splits(f, mesh, *args)
            else:
                f, s2 = D.forest_apply_merges(f, mesh, args[0], *args[2:])
            out[name + "_" + kind + "_status"] = np.asarray(s2)
            save(name + "_" + kind + "_forest_", f)

    fronts("eq", fresh(), "")
    fronts("grow", D.place_forest(D.stack_trees(trees), mesh), "g_")
    fronts("collapse", D.place_forest(D.stack_trees(trees), mesh), "c_")
np.savez(sys.argv[2], **out)
print("DONE")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Inputs and the JAX forest's results on a 4-device host mesh."""
    d = tmp_path_factory.mktemp("forest")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    code = _WORKER.format(fields=T.ARRAY_FIELDS, sizes=UNEQUAL_SIZES,
                          eq_knn=EQ_KNN, uneq_knn=UNEQ_KNN)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                           str(d / "in.npz"), str(d / "out.npz")],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "DONE" in proc.stdout, proc.stderr[-4000:]
    return inp, dict(np.load(d / "out.npz"))


def port_forest(inp):
    return TD.build_forest(inp["X"], S, capacity=16, device="cpu")


def assert_forest_equals(forest, out, prefix):
    arrays, _ = tree_to_numpy(forest)
    for f in T.ARRAY_FIELDS:
        want = out[prefix + f]
        assert arrays[f].dtype == want.dtype and arrays[f].shape == want.shape, f
        np.testing.assert_array_equal(arrays[f], want, err_msg=f"{prefix}{f}")


def jax_fields(t):
    return ({f: np.asarray(getattr(t, f)) for f in T.ARRAY_FIELDS},
            {f: getattr(t, f) for f in T.META_FIELDS})


# --------------------------------------------------------------------------
# forest state
# --------------------------------------------------------------------------
def test_build_forest_bitwise_to_jax_mesh_forest(ref):
    inp, out = ref
    forest = port_forest(inp)
    assert forest.root.shape == (S,) and TD.common_static_height(forest) is not None
    assert_forest_equals(forest, out, "eq_forest_")


def test_stack_trees_zero_pads_like_jnp_pad(ref):
    inp, out = ref
    trees = _unequal_trees(T, inp["XU"], device="cpu")
    forest = TD.stack_trees(trees)
    assert_forest_equals(forest, out, "uneq_forest_")
    assert TD.common_static_height(forest) is None and out["uneq_static_height"] == -1
    # padded rows: dead, and free_list padded with 0 (not -1) outside the ring
    small = int(np.argmin([t.max_nodes for t in trees]))
    n = trees[small].max_nodes
    assert not forest.alive[small, n:].any() and n < forest.max_nodes
    assert (forest.free_list[small, n:] == 0).all()
    assert int(forest.free_head[small]) == int(trees[small].free_head)


def test_unstack_and_carry_across_round_trip():
    XU = clustered(sum(UNEQUAL_SIZES), dims=10, seed=1)
    jtrees = _unequal_trees(J, XU)
    jforest = JD.stack_trees(jtrees)
    arrays, meta = jax_fields(jforest)
    forest = forest_from_numpy(arrays, meta, "cpu")
    back, meta2 = tree_to_numpy(forest)
    assert meta2 == meta
    for f in T.ARRAY_FIELDS:
        assert back[f].dtype == arrays[f].dtype
        np.testing.assert_array_equal(back[f], arrays[f], err_msg=f)
    sizes = [t.max_nodes for t in jtrees]
    for jt, tt in zip(JD.unstack_forest(jforest, sizes), TD.unstack_forest(forest, sizes)):
        a, ma = jax_fields(jt)
        b, mb = tree_to_numpy(tt)
        assert ma == mb
        for f in T.ARRAY_FIELDS:
            np.testing.assert_array_equal(b[f], a[f], err_msg=f)
    # the shards are views: a write through one lands in the forest
    s0 = TD.unstack_forest(forest)[0]
    s0.radius[0, 0] = 123.0
    assert float(forest.radius[0, 0, 0]) == 123.0
    with pytest.raises(ValueError, match="root"):
        forest_from_numpy(jax_fields(jtrees[0])[0], jax_fields(jtrees[0])[1], "cpu")
    bad = dict(arrays, vecs=arrays["vecs"][:, :-1])
    with pytest.raises(ValueError, match="vecs"):
        forest_from_numpy(bad, meta, "cpu")


def test_build_forest_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.build_forest(uniform(80, dims=3, seed=0), 2, capacity=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.build_forest_trees(uniform(80, dims=3, seed=0), 2, capacity=8)


# --------------------------------------------------------------------------
# forest kNN
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(EQ_KNN))
def test_forest_knn_equal_heights_bitwise(ref, case):
    inp, out = ref
    k, F, pp = EQ_KNN[case]
    d, i = TD.forest_knn(port_forest(inp), inp["Q"], k=k, max_frontier=F,
                         parent_prune=pp)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(d.numpy(), out[case + "_d"])
    np.testing.assert_array_equal(i.numpy(), out[case + "_i"])


@pytest.mark.parametrize("case", sorted(UNEQ_KNN))
def test_forest_knn_unequal_heights_falls_back_bitwise(ref, case, monkeypatch):
    inp, out = ref
    k, F, pp = UNEQ_KNN[case]
    forest = TD.stack_trees(_unequal_trees(T, inp["XU"], device="cpu"))
    engines = []
    perquery = T._knn_perquery
    monkeypatch.setattr(T, "_knn_perquery",
                        lambda *a: engines.append("perquery") or perquery(*a))
    monkeypatch.setattr(T, "_knn_cohort",
                        lambda *a, **kw: pytest.fail("cohort engine on unequal shards"))
    d, i = TD.forest_knn(forest, inp["QU"], k=k, max_frontier=F, parent_prune=pp)
    assert engines == ["perquery"] * S
    np.testing.assert_array_equal(d.numpy(), out[case + "_d"])
    np.testing.assert_array_equal(i.numpy(), out[case + "_i"])


def test_forest_knn_small_frontier_overflows(ref):
    """The F=2 and F=3 cases cut shards' frontiers: what the bitwise cases
    above hold includes truncated descents."""
    inp, _ = ref
    forest = port_forest(inp)
    t0 = TD.unstack_forest(forest)[0]
    res = T._knn_cohort(t0, torch.from_numpy(inp["Q"]), float("inf"), k=5, F=2,
                        height=int(t0.height))
    assert res.overflow.any()
    trees = _unequal_trees(T, inp["XU"], device="cpu")
    res = T._knn_perquery(trees[0], torch.from_numpy(inp["QU"]), 4, 3, float("inf"))
    assert res.overflow.any()


def test_forest_knn_merge_ties_shard_major():
    """Every shard holds the same points: each distance ties across all
    shards, and the merge keeps the lowest shard first, as ``lax.top_k``
    over the shard-major layout does."""
    base = uniform(40, dims=4, seed=3)
    X = np.repeat(base, S, axis=0)              # object i -> shard i % S
    forest = TD.build_forest(X, S, capacity=8, device="cpu")
    d, i = TD.forest_knn(forest, base[:5], k=6, max_frontier=64)
    np.testing.assert_array_equal(d[:, :S].numpy(), np.zeros((5, S), np.float32))
    np.testing.assert_array_equal(i[:, :S].numpy() % S, np.tile(np.arange(S), (5, 1)))
    # fewer objects than k in total: inf / -1 pads
    small = TD.build_forest(uniform(6, dims=3, seed=1), 3, capacity=8, device="cpu")
    d, i = TD.forest_knn(small, uniform(2, dims=3, seed=2), k=9)
    assert torch.isposinf(d[:, 6:]).all() and (i[:, 6:] == -1).all()


def sliced_scan(X, Q, k, n_slices):
    """What the group form of ``brute_force_knn`` computes, on one device:
    each contiguous slice scanned and cut to its k best, global ids, then
    the k-way merge of the slices' candidates."""
    X, Q = torch.from_numpy(X), torch.from_numpy(Q)
    size = X.shape[0] // n_slices
    parts = [TD._scan_topk(X[s * size:(s + 1) * size], Q, k, "d_inf")
             for s in range(n_slices)]
    return TD._merge_topk(torch.stack([d for d, _ in parts]),
                          torch.stack([i + s * size for s, (_, i) in enumerate(parts)]),
                          k)


@pytest.mark.parametrize("k", [1, 6])
def test_sharded_brute_force_bitwise(ref, k):
    """The one-device scan and the per-slice scans merged as the group form
    merges them, bitwise to JAX's sharded scan on 4 host devices."""
    inp, out = ref
    d, i = TD.brute_force_knn(inp["X"], inp["Q"], k=k, device="cpu")
    np.testing.assert_array_equal(d.numpy(), out[f"brute_k{k}_d"])
    np.testing.assert_array_equal(i.numpy(), out[f"brute_k{k}_i"])
    d, i = sliced_scan(inp["X"], inp["Q"], k, S)
    np.testing.assert_array_equal(d.numpy(), out[f"brute_k{k}_d"])
    np.testing.assert_array_equal(i.numpy(), out[f"brute_k{k}_i"])
    X = inp["X"][:2997]
    whole = TD.brute_force_knn(X, inp["Q"], k=k, device="cpu")
    d, i = sliced_scan(X, inp["Q"], k, 3)
    assert torch.equal(d, whole[0]) and torch.equal(i, whole[1])


# --------------------------------------------------------------------------
# the per-query engine
# --------------------------------------------------------------------------
@pytest.mark.parametrize("metric", ["d_inf", "l2", "l1"])
def test_knn_perquery_bitwise_vs_jax(metric):
    X = clustered(1500, dims=9, seed=4)
    jt = J.bulk_build(X, capacity=12, metric=metric)
    arrays, meta = jax_fields(jt)
    tt = tree_from_numpy(arrays, meta, "cpu")
    Q = np.vstack([uniform(10, dims=9, seed=5), X[:14] + 0.002]).astype(np.float32)
    for k, F in ((1, 64), (8, 3), (8, 256), (3, 1)):
        want = J.knn(jt, Q, k=k, max_frontier=F, impl="perquery")
        got = T._knn_perquery(tt, torch.from_numpy(Q), k, F, float("inf"))
        for f in FIELDS:
            w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
            assert w.dtype == g.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f"{metric} k={k} F={F} {f}")
        if F <= 3:
            assert got.overflow.any()


def test_knn_perquery_ties_and_range_cap():
    rng = np.random.default_rng(11)
    base = rng.random((100, 6)).astype(np.float32)
    jt = J.bulk_build(np.repeat(base, 4, axis=0), capacity=8)
    tt = tree_from_numpy(*jax_fields(jt), "cpu")
    Q = base[:10] + 0.001
    want = J._knn_perquery(jt, Q, 8, 32, np.float32(0.05))
    got = T._knn_perquery(tt, torch.from_numpy(Q), 8, 32, 0.05)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


# --------------------------------------------------------------------------
# mutation fronts
# --------------------------------------------------------------------------
def test_forest_delete_bitwise(ref):
    inp, out = ref
    forest, found = TD.forest_delete(port_forest(inp), inp["del_xs"], inp["del_oids"])
    np.testing.assert_array_equal(found.numpy(), out["del_found"])
    assert found.dtype == torch.bool
    # some rows underflowed and left their shard as it was
    assert 0 < int((~found[:600]).sum()) and not found[600:].any()
    assert_forest_equals(forest, out, "del_forest_")


def test_forest_apply_mutations_bitwise(ref):
    inp, out = ref
    forest, st = TD.forest_apply_mutations(port_forest(inp), inp["ops"], inp["xs"],
                                           inp["oids"], inp["owner"], validate=True)
    assert st.dtype == torch.int32
    np.testing.assert_array_equal(st.numpy(), out["apply_status"])
    assert {T.ST_NOP, T.ST_APPLIED, T.ST_OVERFLOW, T.ST_UNDERFLOW,
            T.ST_NOTFOUND} <= set(st.tolist())
    assert (st[-3:] == T.ST_NOP).all()           # rows owned by no shard
    assert_forest_equals(forest, out, "apply_forest_")


def test_forest_apply_mutations_validates_the_cohort(ref):
    inp, _ = ref
    forest = port_forest(inp)
    args = (np.array([1, 1]), np.zeros((2, 8), np.float32))
    with pytest.raises(ValueError, match="unique"):
        TD.forest_apply_mutations(forest, *args, np.array([3, 3]), np.array([0, 0]),
                                  validate=True)
    with pytest.raises(ValueError, match="negative"):
        TD.forest_apply_mutations(forest, *args, np.array([3, -1]), np.array([0, 0]),
                                  validate=True)


def test_forest_extract_objects_sums_over_shards(ref):
    inp, out = ref
    vecs, found = TD.forest_extract_objects(port_forest(inp), inp["ex_oids"],
                                            inp["ex_owner"])
    np.testing.assert_array_equal(found.numpy(), out["ex_found"])
    # bytewise: the psum turned the stored -0.0 into +0.0
    assert vecs.numpy().tobytes() == out["ex_vecs"].tobytes()
    assert not np.signbit(vecs[0, :3].numpy()).any()
    assert np.signbit(inp["X"][5, :3]).all()


# --------------------------------------------------------------------------
# the split and merge fronts
# --------------------------------------------------------------------------
FRONTS = {"eq": "", "grow": "g_", "collapse": "c_"}


@pytest.mark.parametrize("case", sorted(FRONTS))
def test_forest_split_and_merge_fronts_bitwise(ref, case):
    """The fast scan, the split front on its overflow rows, then the merge
    front on its underflow rows, as the stream pipeline orders them:
    statuses and every field after each front bitwise to the JAX mesh
    forest.  On the unequal forest, shard 2's root grows inside the stack
    (grow) or collapses to a leaf (collapse)."""
    inp, out = ref
    p = FRONTS[case]
    forest = (port_forest(inp) if case == "eq" else
              TD.stack_trees(_unequal_trees(T, inp["XU"], device="cpu")))
    h0 = forest.height.clone()
    ops, xs, oids, owner = (inp[p + k] for k in ("ops", "xs", "oids", "owner"))
    forest, st = TD.forest_apply_mutations(forest, ops, xs, oids, owner)
    np.testing.assert_array_equal(st.numpy(), out[case + "_scan_status"])
    ran = []
    for kind, code, op in (("split", T.ST_OVERFLOW, T.OP_INSERT),
                           ("merge", T.ST_UNDERFLOW, T.OP_DELETE)):
        idx = _escalation_rows(st, ops, code, op)
        if not len(idx):
            continue
        if kind == "split":
            forest, s2 = TD.forest_apply_splits(forest, ops[idx], xs[idx], oids[idx],
                                                owner[idx])
            assert set(s2.tolist()) == {T.ST_SPLIT}
        else:
            forest, s2 = TD.forest_apply_merges(forest, ops[idx], oids[idx], owner[idx])
            assert set(s2.tolist()) == {T.ST_MERGE}
        assert s2.dtype == torch.int32
        np.testing.assert_array_equal(s2.numpy(), out[f"{case}_{kind}_status"])
        assert_forest_equals(forest, out, f"{case}_{kind}_forest_")
        ran.append(kind)
    assert ran == {"eq": ["split", "merge"], "grow": ["split"],
                   "collapse": ["merge"]}[case]
    if case == "grow":
        assert int(forest.height[2]) == int(h0[2]) + 1
    if case == "collapse":
        assert int(h0[2]) == 2 and int(forest.height[2]) == 1
    for t in TD.unstack_forest(forest):
        SMTreeEngine(t).validate()
