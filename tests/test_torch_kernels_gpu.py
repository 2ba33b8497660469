"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with a CUDA card (the kernels are built for sm_90a):

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Every test asks for the ``cuda`` fixture, which skips when no card is
present — decided at run time, never at import, so every pytest-xdist
worker collects the same tests.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import smtree  # noqa: E402
from repro_torch.core.convert import tree_to_numpy  # noqa: E402
from repro_torch.core.distributed import brute_force_knn  # noqa: E402
from repro_torch.core.engine import SMTreeEngine  # noqa: E402
from repro_torch.data.datagen import clustered, uniform  # noqa: E402
from repro_torch.kernels.distance import (pairwise_distance,  # noqa: E402
                                          pairwise_distance_torch)
from repro_torch.kernels.frontier import (_PRUNE_PAD,  # noqa: E402
                                          frontier_scores,
                                          frontier_scores_torch)

pytestmark = pytest.mark.gpu
METRICS = ["d_inf", "l2", "l1"]
FIELDS = ("dists", "ids", "page_hits", "dist_evals", "overflow")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pages(rng, dev, N, cap, dim):
    vecs = rng.normal(size=(N, cap, dim)).astype(np.float32)
    radius = np.abs(rng.normal(size=(N, cap))).astype(np.float32)
    valid = rng.random((N, cap)) < 0.8
    is_leaf = rng.random(N) < 0.5
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t(vecs), t(radius), t(valid & ~is_leaf[:, None]), t(valid & is_leaf[:, None])


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("cap,dim", [(8, 5), (32, 20), (40, 33), (64, 128)])
def test_frontier_kernel_bitwise(cuda, metric, prune, cap, dim):
    rng = np.random.default_rng(cap * 1000 + dim)
    N, b, w = 37, 9, 6
    vecs, radius, iv, lv = _pages(rng, cuda, N, cap, dim)
    fids = rng.integers(-1, N, size=(b, w)).astype(np.int32)
    fids[0, :] = -1
    fids[1, :] = 0
    fids[2, 0] = N - 1
    queries = torch.from_numpy(rng.normal(size=(b, dim)).astype(np.float32)).to(cuda)
    kw = {}
    if prune:
        qpd = np.abs(rng.normal(size=(b, w))).astype(np.float32)
        qpd[fids < 0] = np.inf
        kw = dict(pdist=torch.from_numpy(np.abs(rng.normal(size=(N, cap))).astype(np.float32)).to(cuda),
                  qpd=torch.from_numpy(qpd).to(cuda),
                  rq=torch.from_numpy(np.abs(rng.normal(size=b)).astype(np.float32)).to(cuda))
    fids = torch.from_numpy(fids).to(cuda)
    got = frontier_scores(fids, queries, vecs, radius, iv, lv, metric=metric, **kw)
    want = frontier_scores_torch(fids, queries, vecs, radius, iv, lv, metric=metric, **kw)
    torch.cuda.synchronize()
    for g, wv, name in zip(got, want, ("dmax", "score", "leaf_d", "dq")):
        assert torch.equal(g, wv), f"{metric}/{name}"


def test_frontier_prune_boundary_is_inclusive(cuda):
    cap, dim = 4, 6
    vecs = torch.zeros((1, cap, dim), device=cuda)
    radius = torch.tensor([[0.0, 0.25, 0.0, 0.0]], device=cuda)
    iv = torch.ones((1, cap), dtype=torch.bool, device=cuda)
    lv = torch.zeros((1, cap), dtype=torch.bool, device=cuda)
    pdist = torch.tensor([[1.0, 0.75, 1.0 - _PRUNE_PAD / 2, 0.875]], device=cuda)
    dmax, *_ = frontier_scores(
        torch.zeros((1, 1), dtype=torch.int32, device=cuda),
        torch.zeros((1, dim), device=cuda), vecs, radius, iv, lv,
        metric="d_inf", pdist=pdist, qpd=torch.tensor([[1.5]], device=cuda),
        rq=torch.tensor([0.5], device=cuda))
    assert torch.isfinite(dmax)[0, 0].tolist() == [True, True, True, False]


def test_frontier_wrapper_checks_and_counts(cuda):
    rng = np.random.default_rng(1)
    vecs, radius, iv, lv = _pages(rng, cuda, 5, 8, 4)
    fids = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    q = torch.zeros((2, 4), device=cuda)
    before = frontier_scores.launches
    frontier_scores(fids, q, vecs, radius, iv, lv, metric="d_inf")
    assert frontier_scores.launches == before + 1
    with pytest.raises(TypeError):
        frontier_scores(fids.long(), q, vecs, radius, iv, lv, metric="d_inf")
    with pytest.raises(ValueError):
        frontier_scores(fids, q.t().contiguous().t(), vecs, radius, iv, lv,
                        metric="d_inf")
    with pytest.raises(ValueError):
        frontier_scores(fids, q.cpu(), vecs, radius, iv, lv, metric="d_inf")
    big = torch.zeros((5, 8, 129), device=cuda)
    with pytest.raises(ValueError):
        frontier_scores(fids, torch.zeros((2, 129), device=cuda), big, radius,
                        iv, lv, metric="d_inf")
    assert frontier_scores.launches == before + 1


@pytest.mark.parametrize("metric", ["d_inf", "sqeuclidean", "ip"])
@pytest.mark.parametrize("nq,ne,d", [(8, 8, 4), (100, 130, 20), (1, 257, 96),
                                     (300, 7, 160), (65, 1000, 33)])
def test_distance_kernel_matches_plain(cuda, metric, nq, ne, d):
    rng = np.random.default_rng(nq * 1000 + ne + d)
    q = torch.from_numpy(rng.normal(size=(nq, d)).astype(np.float32)).to(cuda)
    e = torch.from_numpy(rng.normal(size=(ne, d)).astype(np.float32)).to(cuda)
    before = pairwise_distance.launches
    got = pairwise_distance(q, e, metric)
    want = pairwise_distance_torch(q, e, metric)
    assert pairwise_distance.launches == before + 1
    if metric == "d_inf":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_descent_kernel_path_matches_plain_path(cuda):
    for metric in METRICS:
        X = clustered(3000, dims=12, seed=4)
        tree = smtree.bulk_build(X, capacity=16, metric=metric, device=cuda)
        Q = torch.from_numpy(np.vstack([uniform(12, dims=12, seed=5),
                                        X[:12] + 0.003])).to(cuda)
        for k, F in ((1, 64), (10, 64), (10, 1024)):
            kw = dict(k=k, F=F, height=int(tree.height), level_stats=True)
            a, sa = smtree._knn_cohort(tree, Q, float("inf"), **kw)
            p, sp = smtree._knn_cohort(tree, Q, float("inf"),
                                       scorer=frontier_scores_torch, **kw)
            for f in FIELDS:
                assert torch.equal(getattr(a, f), getattr(p, f)), (metric, k, F, f)
            assert all(torch.equal(x, y) for x, y in zip(sa, sp))


def test_engine_on_card_matches_cpu_engine(cuda):
    X = uniform(400, dims=6, seed=3)
    for metric in METRICS:
        on_card = SMTreeEngine.build(X[:150], ids=np.arange(150), capacity=4,
                                     metric=metric, slack=1.2)     # default: cuda
        assert on_card.tree.device.type == "cuda"
        on_cpu = SMTreeEngine.build(X[:150], ids=np.arange(150), capacity=4,
                                    metric=metric, slack=1.2, device="cpu")
        rng = np.random.default_rng(5)
        live, nxt = set(range(150)), 150
        for _ in range(80):
            if live and rng.random() < 0.45:
                oid = int(rng.choice(sorted(live)))
                assert on_card.delete(X[oid], oid) and on_cpu.delete(X[oid], oid)
                live.discard(oid)
            else:
                on_card.insert(X[nxt], nxt)
                on_cpu.insert(X[nxt], nxt)
                live.add(nxt)
                nxt += 1
        a, _ = tree_to_numpy(on_card.tree)
        c, _ = tree_to_numpy(on_cpu.tree)
        for f in smtree.ARRAY_FIELDS:
            np.testing.assert_array_equal(a[f], c[f], err_msg=f"{metric}/{f}")
        on_card.validate()
        Q = uniform(16, dims=6, seed=9)
        ra = on_card.knn(Q, k=5, max_frontier=256)
        rc = on_cpu.knn(Q, k=5, max_frontier=256)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(ra, f).cpu().numpy(),
                                          getattr(rc, f).numpy())


def test_brute_force_knn_on_card_matches_cpu(cuda):
    X = clustered(5000, dims=20, seed=7)
    Q = X[:40] + 0.01
    dg, ig = brute_force_knn(torch.from_numpy(X).to(cuda), Q, k=9)
    dc, ic = brute_force_knn(torch.from_numpy(X), Q, k=9)
    assert torch.equal(dg.cpu(), dc) and torch.equal(ig.cpu(), ic)
