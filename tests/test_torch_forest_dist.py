"""The forest query and the sharded scan over a ``torch.distributed``
process group: gloo at world size 4 on the CPU, one shard per rank, equal
to the one-device forms.

Four ranks start as subprocesses that meet through a ``file://`` init;
rank 0 writes the results to an ``.npz``.  NCCL, the GPU backend, needs a
card per rank and is not exercised here.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.core import smtree as T  # noqa: E402
from repro_torch.data.datagen import clustered  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
UNEQUAL_SIZES = (900, 120, 20, 400)
CASES = {"eq_F128": (5, 128), "eq_F2": (5, 2)}


def _inputs():
    rng = np.random.default_rng(7)
    X = clustered(2400, dims=12, seed=7)
    Q = np.vstack([X[:16] + rng.normal(0, 0.01, (16, 12)),
                   rng.random((4, 12))]).astype(np.float32)
    XU = clustered(sum(UNEQUAL_SIZES), dims=12, seed=8)
    return X, Q, XU


def _mutation_X():
    """The objects of the mutation fronts: ``_inputs``' set with a stored
    -0.0 in row 5."""
    X = _inputs()[0].copy()
    X[5, :3] = -0.0
    return X


def _mutation_inputs(X):
    """A cohort for the mutation fronts: deletes of every third id (leaves
    thinned below min_fill underflow), piles of 14 inserts that overflow
    a leaf of each shard, NOP rows; then a delete batch and an extract
    batch with a stored -0.0, an absent id, a wrong owner and a pad."""
    rng = np.random.default_rng(9)
    dels = np.arange(0, len(X), 3)
    pile_x = np.vstack([X[i] + rng.normal(0, 1e-4, (14, X.shape[1])) for i in range(WORLD)])
    new = 50_000 + np.arange(len(pile_x))
    ops = np.concatenate([np.full(len(dels), T.OP_DELETE), np.full(len(new), T.OP_INSERT),
                          np.full(2, T.OP_NOP)]).astype(np.int32)
    oids = np.concatenate([dels, new, [60_000, 60_001]]).astype(np.int32)
    xs = np.vstack([X[dels], pile_x, np.zeros((2, X.shape[1]))]).astype(np.float32)
    owner = np.concatenate([dels % WORLD, np.repeat(np.arange(WORLD), 14), [0, 1]])
    order = rng.permutation(len(ops))
    del_oids = np.array([1, 2, 4, 5, 7, 77_777, -1], np.int32)
    ex_oids = np.array([5, 7, 8, 10, 50_001, 11, -1], np.int32)
    ex_owner = np.array([1, 3, 0, 2, 0, 0, 0], np.int32)
    return dict(ops=ops[order], oids=oids[order], xs=xs[order],
                owner=owner[order].astype(np.int32), del_oids=del_oids,
                del_xs=X[np.maximum(del_oids, 0) % len(X)], ex_oids=ex_oids,
                ex_owner=ex_owner)


def mutation_fronts(forest, X, group=None):
    """The five mutation fronts in the stream pipeline's order: the fast
    scan, the split front on its overflow rows, the merge front on its
    underflow rows, then a delete batch and an extract batch."""
    m = _mutation_inputs(X)
    out = {}
    forest, st = TD.forest_apply_mutations(forest, m["ops"], m["xs"], m["oids"],
                                           m["owner"], validate=True, group=group)
    out["scan"] = st.numpy()
    for kind, code, op in (("split", T.ST_OVERFLOW, T.OP_INSERT),
                           ("merge", T.ST_UNDERFLOW, T.OP_DELETE)):
        idx = np.nonzero((out["scan"] == code) & (m["ops"] == op))[0]
        if kind == "split":
            _, s2 = TD.forest_apply_splits(forest, m["ops"][idx], m["xs"][idx],
                                           m["oids"][idx], m["owner"][idx], group=group)
        else:
            _, s2 = TD.forest_apply_merges(forest, m["ops"][idx], m["oids"][idx],
                                           m["owner"][idx], group=group)
        out[kind] = s2.numpy()
    _, found = TD.forest_delete(forest, m["del_xs"], m["del_oids"], group=group)
    out["del_found"] = found.numpy()
    v, f = TD.forest_extract_objects(forest, m["ex_oids"], m["ex_owner"], group=group)
    out["ex_vecs"], out["ex_found"] = v.numpy(), f.numpy()
    return forest, out


def _unequal_trees(XU):
    out, lo = [], 0
    for s, n in enumerate(UNEQUAL_SIZES):
        idx = np.arange(lo, lo + n)
        out.append(T.bulk_build(XU[idx], ids=idx, capacity=8, seed=s, device="cpu"))
        lo += n
    return out


_RANK = """
import sys
import numpy as np
import torch.distributed as dist
sys.path.insert(0, {tests!r})
import test_torch_forest_dist as tfd
from repro_torch.core import distributed as TD
from repro_torch.core import smtree as T

rank, init, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size={world})
try:
    X, Q, XU = tfd._inputs()
    res = {{}}
    tree = TD.build_forest_trees(X, {world}, capacity=16, device="cpu")[rank]
    for name, (k, F) in tfd.CASES.items():
        d, i = TD.forest_knn(tree, Q, k=k, max_frontier=F, group=dist.group.WORLD)
        res[name + "_d"], res[name + "_i"] = d.numpy(), i.numpy()
    tree = tfd._unequal_trees(XU)[rank]
    d, i = TD.forest_knn(tree, Q, k=4, max_frontier=3, group=dist.group.WORLD)
    res["uneq_d"], res["uneq_i"] = d.numpy(), i.numpy()
    size = X.shape[0] // {world}
    d, i = TD.brute_force_knn(X[rank * size:(rank + 1) * size], Q, k=6,
                              group=dist.group.WORLD, device="cpu")
    res["brute_d"], res["brute_i"] = d.numpy(), i.numpy()
    Xm = tfd._mutation_X()
    tree = TD.build_forest_trees(Xm, {world}, capacity=16, device="cpu")[rank]
    tree, mres = tfd.mutation_fronts(tree, Xm, group=dist.group.WORLD)
    res.update({{"mut_" + k: v for k, v in mres.items()}})
    for f in T.ARRAY_FIELDS:
        res["tree_" + f] = getattr(tree, f).numpy()
    np.savez(out_path + "." + str(rank) + ".npz", **res)
finally:
    dist.destroy_process_group()
print("RANK_DONE", rank)
"""


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo")
    code = textwrap.dedent(_RANK.format(tests=str(ROOT / "tests"), world=WORLD))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    init = f"file://{d / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), init,
                               str(d / "out.npz")], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_DONE {r}" in so, se[-3000:]
    ranks = [dict(np.load(d / f"out.npz.{r}.npz")) for r in range(WORLD)]
    return dict(ranks[0], ranks=ranks)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gloo_forest_knn_equals_one_device(gloo, case):
    X, Q, _ = _inputs()
    k, F = CASES[case]
    forest = TD.build_forest(X, WORLD, capacity=16, device="cpu")
    d, i = TD.forest_knn(forest, Q, k=k, max_frontier=F)
    np.testing.assert_array_equal(gloo[case + "_d"], d.numpy())
    np.testing.assert_array_equal(gloo[case + "_i"], i.numpy())
    assert gloo[case + "_i"].dtype == np.int32


def test_gloo_forest_knn_unequal_heights_equals_one_device(gloo):
    _, Q, XU = _inputs()
    trees = _unequal_trees(XU)
    assert len({int(t.height) for t in trees}) > 1
    d, i = TD.forest_knn(TD.stack_trees(trees), Q, k=4, max_frontier=3)
    np.testing.assert_array_equal(gloo["uneq_d"], d.numpy())
    np.testing.assert_array_equal(gloo["uneq_i"], i.numpy())


def test_gloo_sharded_scan_equals_one_device(gloo):
    X, Q, _ = _inputs()
    d, i = TD.brute_force_knn(X, Q, k=6, device="cpu")
    np.testing.assert_array_equal(gloo["brute_d"], d.numpy())
    np.testing.assert_array_equal(gloo["brute_i"], i.numpy())


def test_gloo_mutation_fronts_equal_one_device(gloo):
    """The five mutation fronts with a group (each rank applies the rows it
    owns, then the masked rows are summed over the ranks) equal the
    one-device forms over the stacked forest: statuses, found masks, the
    extracted rows bytewise (a stored -0.0 comes back +0.0 from both), and
    every rank's tree field for field against its shard."""
    X = _mutation_X()
    forest = TD.build_forest(X, WORLD, capacity=16, device="cpu")
    forest, want = mutation_fronts(forest, X)
    for r, got in enumerate(gloo["ranks"]):
        for k, w in want.items():
            g = got["mut_" + k]
            assert g.dtype == w.dtype, k
            assert g.tobytes() == w.tobytes(), f"rank {r}: {k}"
    assert T.ST_SPLIT in want["split"] and T.ST_MERGE in want["merge"]
    assert want["del_found"].any() and not want["del_found"].all()
    assert want["ex_found"].sum() >= 4 and want["ex_found"][0]
    assert not np.signbit(want["ex_vecs"][0, :3]).any() and np.signbit(X[5, :3]).all()
    for r, shard in enumerate(TD.unstack_forest(forest)):
        for f in T.ARRAY_FIELDS:
            np.testing.assert_array_equal(gloo["ranks"][r]["tree_" + f],
                                          getattr(shard, f).numpy(), err_msg=f"rank {r} {f}")
