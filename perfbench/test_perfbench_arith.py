"""The benchmark's arithmetic on hand-worked cases, its inputs' dependence
on ``--seed`` alone, and the check that nothing it loads is JAX."""
from __future__ import annotations

import ast
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import datagen, harness, lm_weights, profiling, roofline, stats

HERE = Path(__file__).resolve().parent


def test_percentile_and_spread_by_hand():
    xs = [5, 1, 4, 2, 3]
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 95) == pytest.approx(4.8)      # 4 + 0.8 * (5 - 4)
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    # quartiles of 1..8 by the exclusive method: 2.25 and 6.75, median 4.5
    assert stats.spread(range(1, 9)) == pytest.approx((6.75 - 2.25) / 4.5)
    q1, _, q3 = statistics.quantiles([10, 10.1, 9.9, 10.2, 9.8, 10], n=4)
    assert stats.spread([10, 10.1, 9.9, 10.2, 9.8, 10]) == pytest.approx(
        (q3 - q1) / statistics.median([10, 10.1, 9.9, 10.2, 9.8, 10]))


def test_interpolated_rate_by_hand():
    # items of 10 units served over [0, 2], [2, 4], [4, 6]; window [1, 5]:
    # half of the first, all of the second, half of the third = 20 in 4 s
    acks = [(2.0, 10), (4.0, 10), (6.0, 10)]
    assert stats.interpolated_rate(acks, 1.0, 5.0, 0.0) == pytest.approx(5.0)
    # a window that holds whole items only
    assert stats.interpolated_rate(acks, 0.0, 4.0, 0.0) == pytest.approx(5.0)
    with pytest.raises(ValueError):
        stats.interpolated_rate(acks[:2], 1.0, 5.0, 0.0)     # the last item is missing


def test_frontier_work_by_hand():
    # one query, a frontier of two slots (page 3, empty), cap 2, dim 4;
    # entries live: page 3 both, so 2 live entries, 2 distinct vector rows
    fids = torch.tensor([[3, -1]], dtype=torch.int32)
    q = torch.zeros((1, 4))
    inf = float("inf")
    dmax = torch.tensor([[[1.0, 2.0], [inf, inf]]])
    leaf = torch.full((1, 2, 2), inf)
    outs = (dmax, dmax, leaf, dmax)
    ops, nbytes = roofline.frontier_work(fids, q, outs, cap=2, prune=False)
    assert ops == 2 * 4 * 3 + 4 * 1 * 2 * 2                   # 24 + 16
    # fids 8 + queries 16 + 1 page x 2 x (4 + 1 + 1) + 2 rows x 4 x 4 + outputs 4 x 4 x 4
    assert nbytes == 8 + 16 + 12 + 32 + 64
    ops_p, nbytes_p = roofline.frontier_work(fids, q, outs, cap=2, prune=True)
    assert ops_p == ops
    assert nbytes_p == nbytes + 1 * 2 * 4 + 1 * 2 * 4 + 1 * 4   # pdist, qpd, rq


def test_bound_and_decode_flops_by_hand():
    assert roofline.bound_s(67e12, 1.0) == pytest.approx(1.0)          # compute-bound
    assert roofline.bound_s(1.0, 3.35e12) == pytest.approx(1.0)        # memory-bound
    cfg = {"d_model": 8, "n_layers": 2, "n_heads": 2, "n_kv_heads": 1, "d_ff": 16,
           "vocab_size": 10}
    # per layer: q 8x8 + k, v 2 x 8x4 + o 8x8 + MLP 2 x 8x16 = 448; head 80
    want = 2.0 * (2 * 448 + 80) + 4.0 * 2 * 2 * 4 * 5
    assert roofline.decode_flops_per_token(cfg, context=5) == want
    sc2 = json.load(open(HERE / "configs" / "starcoder2-3b-knnlm.json"))
    # the non-embedding weights of starcoder2-3b as the port holds them
    # (no biases, no norms), twice, at context 0
    D, F = 3072, 12288
    n = 30 * (D * D + 2 * D * 256 + D * D + 2 * D * F) + D * 49152
    assert roofline.decode_flops_per_token(sc2, 0) == 2.0 * n


def test_device_trace_summary_by_hand():
    class Ev:
        def __init__(self, name, dev, start, dur, ann=False):
            self._n, self._d, self._s, self._u, self._a = name, dev, start, dur, ann

        def name(self):
            return self._n

        def device_type(self):
            return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._u

        def is_user_annotation(self):
            return self._a
    evs = [Ev("k1", True, 100, 200), Ev("k2", True, 250, 100),   # union 100-350
           Ev("k1", True, 600, 100),                               # 600-700
           Ev("k3", True, 1100, 50),                               # after the phase
           Ev("aten::sort", False, 350, 250), Ev("outer", False, 0, 1000)]
    s = profiling.summary(evs, 0, 1000)
    assert s["window_s"] == pytest.approx(1e-6)
    assert s["busy_s"] == pytest.approx(350e-9)                  # 250 + 100
    assert s["kernels"]["k1"] == [pytest.approx(300e-9), 2]
    assert s["device_ops"][0][0] == "k1"
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::sort"] == pytest.approx(250e-9)            # 350-600
    assert gaps["outer"] == pytest.approx(100e-9 + 300e-9)        # 0-100, 700-1000


def test_streams_depend_on_the_seed_alone():
    big = 2**31 + 977
    a = datagen.clustered(50, dims=20, n_clusters=5, spread=0.1,
                          seed_rng=datagen.rng(big, "objects"))
    b = datagen.clustered(50, dims=20, n_clusters=5, spread=0.1,
                          seed_rng=datagen.rng(big, "objects"))
    c = datagen.clustered(50, dims=20, n_clusters=5, spread=0.1,
                          seed_rng=datagen.rng(big + 1, "objects"))
    assert np.array_equal(a[0], b[0]) and not np.array_equal(a[0], c[0])
    s1 = datagen.IndexStream(datagen.rng(big, "queries"), 1000, block=7)
    s2 = datagen.IndexStream(datagen.rng(big, "queries"), 1000, block=7)
    assert [s1.next() for _ in range(30)] == [s2.next() for _ in range(30)]
    assert datagen.torch_seed(big, "weights") == datagen.torch_seed(big, "weights")
    assert datagen.torch_seed(big, "weights") != datagen.torch_seed(big, "keys")


def test_churn_plan_is_the_same_for_a_seed():
    from perfbench.drivers.mutation_closed_loop import ChurnPlan
    cfg = {"dims": 20, "n_clusters": 5, "spread": 0.1}
    tr = {"deletes": 8, "inserts": 8}

    def tickets(seed):
        X, centres = datagen.clustered(100, seed_rng=datagen.rng(seed, "objects"), **cfg)
        plan = ChurnPlan(X, centres, cfg, tr, seed)
        return [plan.next() for _ in range(30)]
    t1, t2, t3 = tickets(5), tickets(5), tickets(6)
    for x, y in zip(t1, t2):
        for u, v in zip(x, y):
            assert np.array_equal(u, v)
    assert any(not np.array_equal(x[2], y[2]) for x, y in zip(t1, t3))
    live = set(range(100))
    for ops, xs, oids, dels, ins in t1:                 # every delete meets a live id
        assert set(dels.tolist()) <= live
        live -= set(dels.tolist())
        live |= set(ins.tolist())
        assert len(ops) == len(xs) == len(oids) == 16


def test_weights_are_the_same_for_a_seed():
    cfg = {"n_layers": 1, "d_model": 8, "n_heads": 2, "n_kv_heads": 1, "d_ff": 16,
           "vocab_size": 12, "qkv_bias": True}
    a, b = lm_weights.make(cfg, 3, "cpu"), lm_weights.make(cfg, 3, "cpu")
    c = lm_weights.make(cfg, 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert torch.allclose(a["layers.0.norm1.scale"], torch.ones(8), atol=0.2)


def test_forbidden_names_are_compared_whole():
    names = ("repro_torch_fake_for_test", "repro.fake_for_test")
    try:
        sys.modules[names[0]] = sys
        assert names[0] not in harness.forbidden_modules()
        sys.modules[names[1]] = sys
        assert names[1] in harness.forbidden_modules()
    finally:
        for n in names:
            sys.modules.pop(n, None)


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_of_the_harness_imports_jax_and_the_reference_none_of_the_port():
    for p in HERE.rglob("*.py"):
        assert not _imports(p) & set(harness.FORBIDDEN), p
    for p in (HERE / "reference").glob("*.py"):
        assert "repro_torch" not in _imports(p), p


def test_a_run_loads_no_jax_module():
    """A whole tiny run in a fresh process, then its ``sys.modules``."""
    code = (
        "import sys, json; sys.path[:0] = [{root!r}, {src!r}]\n"
        "from perfbench import harness\n"
        "from perfbench.conftest import TINY\n"
        "harness.run_cell('idx1m-dinf.knn-exact', 1, 0.5, False, device='cpu',"
        " overrides=TINY['idx1m-dinf.knn-exact'])\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
    ).format(root=str(HERE.parent), src=str(HERE.parent / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
