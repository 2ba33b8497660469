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
    if rank == 0:
        np.savez(out_path, **res)
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
    return dict(np.load(d / "out.npz"))


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
