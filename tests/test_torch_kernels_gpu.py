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

from repro_torch.core import distributed as fd  # noqa: E402
from repro_torch.core import smtree  # noqa: E402
from repro_torch.core.convert import tree_to_numpy  # noqa: E402
from repro_torch.core.distributed import brute_force_knn  # noqa: E402
from repro_torch.core.engine import SMTreeEngine  # noqa: E402
from repro_torch.data.datagen import clustered, uniform  # noqa: E402
from repro_torch.kernels.distance import (pairwise_distance,  # noqa: E402
                                          pairwise_distance_prune,
                                          pairwise_distance_prune_torch,
                                          pairwise_distance_torch)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_fwd, flash_attention_torch)
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


# narrow rows (dim <= 128): every dim whose fold takes another branch, at
# caps of one and two entries a lane (cap * dim % 4 != 0 among them)
NARROW_DIMS = (1, 2, 3, 20, 31, 32, 33, 64, 127, 128)
NARROW_CAPS = (1, 7, 32, 33, 64)


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("cap,dim", [(8, 5), (40, 33), (32, 2048), (16, 1023), (32, 896),
                                     (64, 129), (32, 384), (16, 3072), (16, 4096)]
                         + [(c, d) for c in NARROW_CAPS for d in NARROW_DIMS])
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


def _narrow_case(rng, dev, N, cap, dim, b, w, *, vecs=None):
    """Pages, queries and filter inputs around d_inf's scale at dim ``dim``
    (the filter keeps some entries and drops others)."""
    pv, radius, iv, lv = _pages(rng, dev, N, cap, dim)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    filt = dict(pdist=t(np.abs(1 + 0.5 * rng.normal(size=(N, cap))) * 2),
                qpd=t(np.abs(1 + 0.5 * rng.normal(size=(b, w))) * 2),
                rq=t(rng.uniform(0.1, 1.0, b)))
    return (vecs if vecs is not None else pv), radius, iv, lv, t(rng.normal(size=(b, dim))), filt


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("cap,dim", [(32, 20), (7, 3), (33, 64)])
def test_frontier_narrow_unaligned_pages(cuda, metric, prune, cap, dim):
    """Pages and queries that start 4 bytes past a 16-byte boundary, and
    validity rows that start 1 byte past a 4-byte one."""
    rng = np.random.default_rng(cap + dim)
    N, b, w = 23, 17, 9
    flat = torch.from_numpy(rng.normal(size=N * cap * dim + 1).astype(np.float32)).to(cuda)
    vecs = flat[1:].view(N, cap, dim)
    vecs, radius, iv, lv, _, filt = _narrow_case(rng, cuda, N, cap, dim, b, w, vecs=vecs)
    shifted = lambda m: torch.cat([m.new_zeros(1), m.reshape(-1)])[1:].view(N, cap)
    iv, lv = shifted(iv), shifted(lv)
    qflat = torch.from_numpy(rng.normal(size=b * dim + 1).astype(np.float32)).to(cuda)
    queries = qflat[1:].view(b, dim)
    assert vecs.data_ptr() % 16 == 4 and queries.data_ptr() % 16 == 4
    assert iv.data_ptr() % 4 == 1 and lv.data_ptr() % 4 == 1
    fids = torch.from_numpy(rng.integers(-1, N, (b, w)).astype(np.int32)).to(cuda)
    _wide_launch_matches_plain(fids, queries, vecs, radius, iv, lv, metric,
                               filt if prune else {})


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("case", ["root", "empty", "pruned", "waves"])
def test_frontier_narrow_path_shapes(cuda, metric, case):
    """The path's extremes at dim 20, cap 32: every pair on one node (the
    root level, b=1024, unfiltered and filtered), every slot empty, every
    page pruned, and more pairs than one wave of persistent warps holds
    (b=4096, F=64: several ranges a warp)."""
    rng = np.random.default_rng(len(case))
    N, cap, dim = 300, 32, 20
    b, w = {"root": (1024, 1), "empty": (64, 16), "pruned": (64, 16), "waves": (4096, 64)}[case]
    vecs, radius, iv, lv, queries, filt = _narrow_case(rng, cuda, N, cap, dim, b, w)
    fids = torch.from_numpy(rng.integers(0, N, (b, w)).astype(np.int32)).to(cuda)
    if case == "root":
        fids.zero_()
    if case == "empty":
        fids.fill_(-1)
    if case == "pruned":
        filt["rq"].zero_()
        filt["qpd"].fill_(1e6)
    for f in ({}, filt):
        want = _wide_launch_matches_plain(fids, queries, vecs, radius, iv, lv, metric, f)
        live = torch.isfinite(want[0]) | torch.isfinite(want[2])
        if case == "empty" or (case == "pruned" and f):
            assert not bool(live.any())
        else:
            assert bool(live.any())


def _wide_launch_matches_plain(fids, queries, vecs, radius, iv, lv, metric, filt):
    got = frontier_scores(fids, queries, vecs, radius, iv, lv, metric=metric, **filt)
    want = frontier_scores_torch(fids, queries, vecs, radius, iv, lv, metric=metric, **filt)
    torch.cuda.synchronize()
    for g, wv, name in zip(got, want, ("dmax", "score", "leaf_d", "dq")):
        assert torch.equal(g, wv), f"{metric}/{name}"
    return want


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,w", [(1, 1), (4, 1), (64, 1), (64, 32), (2048, 1)])
def test_frontier_wide_every_pair_on_one_node(cuda, metric, b, w):
    """Level 0's shape (every query scores the root), and launches wide
    enough that blocks take runs of 8 pairs on one node (at w = 1, 8 query
    rows: more dynamic shared memory than a launch gets by default); under
    the filter with its own qpd and rq per pair, so one shared row is kept
    by some queries and dropped by others."""
    rng = np.random.default_rng(b * 100 + w)
    N, cap, dim = 6, 32, 2048
    vecs, radius, iv, lv = _pages(rng, cuda, N, cap, dim)
    scale = {"d_inf": 4.0, "l2": (2.0 * dim) ** 0.5, "l1": 1.128 * dim}[metric]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(cuda)
    pdist = t(np.abs(1 + 0.15 * rng.normal(size=(N, cap))) * scale)
    qpd = t(np.abs(1 + 0.15 * rng.normal(size=(b, w))) * scale)
    rq = t(rng.uniform(0.02, 0.2, b) * scale)
    fids = torch.full((b, w), 3, dtype=torch.int32, device=cuda)
    queries = t(rng.normal(size=(b, dim)))
    want = _wide_launch_matches_plain(fids, queries, vecs, radius, iv, lv, metric,
                                      dict(pdist=pdist, qpd=qpd, rq=rq))
    if b > 1:
        kept = (torch.isfinite(want[0]) | torch.isfinite(want[2])).reshape(b * w, cap)
        valid = (iv | lv)[3]
        assert bool((kept.any(0) & ~kept.all(0) & valid).any()), "no row split by the filter"


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dim", [2048, 1023, 3072])
def test_frontier_wide_duplicate_ids_among_empty_slots(cuda, metric, prune, dim):
    """A few node ids repeated, unsorted, among -1 slots, in a launch with
    runs of 8 pairs a block."""
    rng = np.random.default_rng(dim + prune)
    N, cap, b, w = 9, 16, 64, 24
    vecs, radius, iv, lv = _pages(rng, cuda, N, cap, dim)
    fids = rng.choice([0, 4, 8], size=(b, w)).astype(np.int32)
    fids[rng.random((b, w)) < 0.4] = -1
    filt = {}
    if prune:
        qpd = np.abs(rng.normal(size=(b, w))).astype(np.float32)
        qpd[fids < 0] = np.inf
        filt = dict(pdist=torch.from_numpy(np.abs(rng.normal(size=(N, cap))).astype(np.float32)).to(cuda),
                    qpd=torch.from_numpy(qpd).to(cuda),
                    rq=torch.from_numpy(np.abs(rng.normal(size=b)).astype(np.float32)).to(cuda))
    queries = torch.from_numpy(rng.normal(size=(b, dim)).astype(np.float32)).to(cuda)
    _wide_launch_matches_plain(torch.from_numpy(fids).to(cuda), queries, vecs, radius,
                               iv, lv, metric, filt)


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
    assert frontier_scores.launches == before + 1
    wide = _pages(rng, cuda, 5, 65, 4)                 # cap above 64: one launch
    _wide_launch_matches_plain(fids, q, *wide, "d_inf", {})
    assert frontier_scores.launches == before + 2


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dim", [20, 2048])
@pytest.mark.parametrize("cap", [65, 96, 97, 128, 257])
def test_frontier_pages_wider_than_64_entries(cuda, metric, prune, cap, dim):
    """Pages above 64 entries (scored as segments of at most 64), narrow
    and wide rows: bitwise, one launch, live entries in the last segment."""
    rng = np.random.default_rng(cap * 10 + dim + prune)
    N, b, w = 7, 9, 5
    vecs, radius, iv, lv, queries, filt = _narrow_case(rng, cuda, N, cap, dim, b, w)
    if dim > 128:                                # the filter's scale at wide rows
        scale = {"d_inf": 4.0, "l2": (2.0 * dim) ** 0.5, "l1": 1.128 * dim}[metric]
        filt = {k: v * scale for k, v in filt.items()}
    fids = torch.from_numpy(rng.integers(-1, N, (b, w)).astype(np.int32)).to(cuda)
    fids[0, 0] = N - 1
    before = frontier_scores.launches
    want = _wide_launch_matches_plain(fids, queries, vecs, radius, iv, lv, metric,
                                      filt if prune else {})
    assert frontier_scores.launches == before + 1
    live = torch.isfinite(want[0]) | torch.isfinite(want[2])
    assert bool(live[..., 64 * ((cap - 1) // 64):].any())


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


def _dist_inputs(rng, dev, nq, ne, d, *, offset=False):
    """Uniform [0, 1) rows; with ``offset`` as views that start one float
    past the allocation (4 bytes past a 16-byte boundary)."""
    def rows(n):
        flat = torch.from_numpy(rng.random(n * d + offset, np.float32)).to(dev)
        return flat[int(offset):].view(n, d)
    return rows(nq), rows(ne)


def _dist_matches_plain(q, e, metric):
    before = pairwise_distance.launches
    got = pairwise_distance(q, e, metric)
    want = pairwise_distance_torch(q, e, metric)
    assert pairwise_distance.launches == before + 1
    if metric == "d_inf":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# the distance kernel's tiles are 64 queries x 256 entries, its stages 32
# dimensions wide: shapes one either side of those edges and below them
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("metric", ["d_inf", "sqeuclidean", "ip"])
@pytest.mark.parametrize("d", [1, 3, 20, 21, 33, 96, 128, 257])
def test_distance_kernel_ragged_shapes(cuda, metric, d, offset):
    rng = np.random.default_rng(d * 2 + offset)
    for nq, ne in ((65, 257), (63, 255), (7, 1030)):
        q, e = _dist_inputs(rng, cuda, nq, ne, d, offset=offset)
        if offset:
            assert q.data_ptr() % 16 == 4 and e.data_ptr() % 16 == 4
        _dist_matches_plain(q, e, metric)


@pytest.mark.parametrize("metric", ["d_inf", "sqeuclidean", "ip"])
@pytest.mark.parametrize("nq,ne,d", [(1, 1, 20), (1, 1, 3), (1, 5000, 20), (3000, 1, 20),
                                     (300, 70_001, 20), (1024, 65_536, 20)])
def test_distance_kernel_single_rows_and_many_tiles(cuda, metric, nq, ne, d):
    """nq = 1 and ne = 1, and shapes with more tiles than the persistent
    blocks (each block walks several; 70,001 leaves a ragged last tile and
    rows whose length is not a multiple of 4)."""
    q, e = _dist_inputs(np.random.default_rng(nq + ne), cuda, nq, ne, d)
    _dist_matches_plain(q, e, metric)


def test_distance_kernel_at_the_index_paths_shape(cuda):
    """The scan behind brute_force_knn on the index path: 256 x 1,000,000 x 20."""
    q, e = _dist_inputs(np.random.default_rng(256), cuda, 256, 1_000_000, 20)
    _dist_matches_plain(q, e, "d_inf")


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("metric", ["d_inf", "sqeuclidean", "ip"])
@pytest.mark.parametrize("nq,ne,d", [(65, 257, 1), (63, 1030, 21), (1, 1, 20), (130, 7, 33),
                                     (300, 70_001, 20), (7, 300, 257)])
def test_distance_prune_kernel_ragged_shapes(cuda, metric, nq, ne, d, offset):
    rng = np.random.default_rng(nq * 7 + ne + d + offset)
    q, e = _dist_inputs(rng, cuda, nq, ne, d, offset=offset)
    lo, hi = {"ip": (-0.2 * d, -0.05 * d), "sqeuclidean": (0.1 * d ** 0.5, 0.35 * d ** 0.5),
              "d_inf": (0.0, 0.6)}[metric]
    r_q = torch.from_numpy(rng.uniform(lo, hi, nq).astype(np.float32)).to(cuda)
    r_e = torch.from_numpy(rng.uniform(lo, hi, ne).astype(np.float32)).to(cuda)
    before = pairwise_distance_prune.launches
    gd, gm = pairwise_distance_prune(q, e, r_q, r_e, metric)
    wd, wm = pairwise_distance_prune_torch(q, e, r_q, r_e, metric)
    assert pairwise_distance_prune.launches == before + 1
    torch.testing.assert_close(gd, wd, rtol=1e-5, atol=1e-5)
    true_d = wd.clamp_min(0).double().sqrt() if metric == "sqeuclidean" else wd.double()
    decided = (true_d - (r_q[:, None] + r_e[None, :]).double()).abs() > 1e-6
    assert torch.equal(gm[decided], wm[decided])


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
    dc, ic = brute_force_knn(X, Q, k=9, device="cpu")
    assert torch.equal(dg.cpu(), dc) and torch.equal(ig.cpu(), ic)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("F", [4, 64, 1024])
def test_forest_descent_kernel_path_matches_plain_path(cuda, metric, F):
    """Each shard's descent through the frontier kernels (both forms)
    against the same forest through the plain scorer, and the card's forest
    against the CPU's: the merged results and every shard's five fields."""
    X = clustered(20_000, dims=20, seed=5)
    forest = fd.build_forest(X, 4, capacity=32, metric=metric, device=cuda)
    Q = torch.from_numpy(X[::500] + 0.01).to(cuda)
    n0 = frontier_scores.launches
    d, i = fd.forest_knn(forest, Q, k=10, max_frontier=F)
    assert frontier_scores.launches > n0 and frontier_scores.pruned_launches > 0
    dp, ip = fd.forest_knn(forest, Q, k=10, max_frontier=F, _scorer=frontier_scores_torch)
    assert torch.equal(d, dp) and torch.equal(i, ip)
    cpu = fd.build_forest(X, 4, capacity=32, metric=metric, device="cpu")
    dc, ic = fd.forest_knn(cpu, Q.cpu(), k=10, max_frontier=F)
    assert torch.equal(d.cpu(), dc) and torch.equal(i.cpu(), ic)
    h = fd.common_static_height(forest)
    for t in fd.unstack_forest(forest):
        a = smtree._knn_cohort(t, Q, float("inf"), k=10, F=F, height=h)
        p = smtree._knn_cohort(t, Q, float("inf"), k=10, F=F, height=h,
                               scorer=frontier_scores_torch)
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(p, f)), f


def test_forest_fronts_on_card_match_cpu(cuda):
    """The sharded scan, the per-query engine and the mutation fronts give
    the CPU's results and tree bytes on the card."""
    X = clustered(8000, dims=20, seed=6)
    Q = X[:32] + 0.01
    Xd, Qd = torch.from_numpy(X).to(cuda), torch.from_numpy(Q).to(cuda)
    parts = [fd._scan_topk(Xd[s * 2000:(s + 1) * 2000], Qd, 7, "d_inf") for s in range(4)]
    d, i = fd._merge_topk(torch.stack([p[0] for p in parts]),
                          torch.stack([p[1] + s * 2000 for s, p in enumerate(parts)]), 7)
    dc, ic = brute_force_knn(X, Q, k=7, device="cpu")
    assert torch.equal(d.cpu(), dc) and torch.equal(i.cpu(), ic)
    d, i = brute_force_knn(Xd, Qd, k=7, device=cuda)
    assert torch.equal(d.cpu(), dc) and torch.equal(i.cpu(), ic)
    forests = [fd.build_forest(X, 4, capacity=16, device=dev) for dev in (cuda, "cpu")]
    t = [fd.unstack_forest(f)[1] for f in forests]
    a, b = (smtree._knn_perquery(tt, torch.from_numpy(Q).to(tt.device), 5, 16,
                                 float("inf")) for tt in t)
    for f in FIELDS:
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    rng = np.random.default_rng(0)
    oids = np.concatenate([rng.choice(8000, 300, replace=False), 9000 + np.arange(300)])
    ops = np.where(oids < 8000, smtree.OP_DELETE, smtree.OP_INSERT).astype(np.int32)
    xs = np.where((oids < 8000)[:, None], X[np.minimum(oids, 7999)],
                  rng.random((600, 20))).astype(np.float32)
    sts = [fd.forest_apply_mutations(f, ops, xs, oids, oids % 4)[1] for f in forests]
    assert torch.equal(sts[0].cpu(), sts[1])
    for name in smtree.ARRAY_FIELDS:
        assert torch.equal(getattr(forests[0], name).cpu(), getattr(forests[1], name)), name
    ex = [fd.forest_extract_objects(f, oids, oids % 4) for f in forests]
    assert torch.equal(ex[0][0].cpu(), ex[1][0]) and torch.equal(ex[0][1].cpu(), ex[1][1])


@pytest.mark.parametrize("metric", METRICS)
def test_split_merge_passes_on_card_match_cpu(cuda, metric):
    """``apply_mutations`` with the device split and merge passes, and the
    forest's split and merge fronts, give the CPU's statuses and tree bytes
    on the card."""
    X = clustered(3000, dims=20, seed=8)
    rng = np.random.default_rng(8)
    centres = np.arange(0, 600, 61)
    piles = np.vstack([X[i] + rng.normal(0, 1e-4, (14, 20)) for i in centres])
    dels = rng.choice(3000, 1200, replace=False)
    ops = np.concatenate([np.full(len(piles), smtree.OP_INSERT),
                          np.full(len(dels), smtree.OP_DELETE)]).astype(np.int32)
    oids = np.concatenate([10_000 + np.arange(len(piles)), dels]).astype(np.int32)
    xs = np.vstack([piles, X[dels]]).astype(np.float32)
    # a forest shard holds object i % 4: each pile goes to its centre's
    owner = np.concatenate([np.repeat(centres % 4, 14), dels % 4]).astype(np.int32)
    order = rng.permutation(len(ops))
    ops, oids, xs, owner = ops[order], oids[order], xs[order], owner[order]
    trees = [smtree.bulk_build(X, capacity=16, metric=metric, fill_frac=0.6, device=dev)
             for dev in (cuda, "cpu")]
    sts = [smtree.apply_mutations(t, ops, xs, oids)[1] for t in trees]
    assert torch.equal(sts[0].cpu(), sts[1])
    assert {smtree.ST_SPLIT, smtree.ST_MERGE} <= set(sts[1].tolist())
    for name in smtree.ARRAY_FIELDS:
        assert torch.equal(getattr(trees[0], name).cpu(), getattr(trees[1], name)), name
    forests = [fd.build_forest(X, 4, capacity=16, metric=metric, device=dev)
               for dev in (cuda, "cpu")]
    st = fd.forest_apply_mutations(forests[1], ops, xs, oids, owner)[1].numpy()
    fd.forest_apply_mutations(forests[0], ops, xs, oids, owner)
    over = np.nonzero(st == smtree.ST_OVERFLOW)[0]
    under = np.nonzero(st == smtree.ST_UNDERFLOW)[0]
    assert len(over) and len(under)
    for f in forests:
        a = fd.forest_apply_splits(f, ops[over], xs[over], oids[over], owner[over])[1]
        b = fd.forest_apply_merges(f, ops[under], oids[under], owner[under])[1]
        assert set(a.tolist()) == {smtree.ST_SPLIT} and set(b.tolist()) == {smtree.ST_MERGE}
    for name in smtree.ARRAY_FIELDS:
        assert torch.equal(getattr(forests[0], name).cpu(), getattr(forests[1], name)), name


@pytest.mark.parametrize("mesh", [None, "stacked"])
def test_stream_plane_on_card_matches_cpu(cuda, mesh):
    """``StreamingForest`` (either plane) and ``StreamingEngine`` on the
    card: a drain of one shard, incremental rebalancing and pinned kNN give
    the CPU's digests, ownership and results."""
    from repro_torch.serve.frontend import pinned_knn
    from repro_torch.stream import StreamingEngine, StreamingForest, tree_digest
    X = clustered(6000, dims=20, seed=9)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        f = StreamingForest(fd.build_forest_trees(X, 4, capacity=16, device=dev),
                            mesh=None if mesh is None else dev, max_batch=256,
                            rebalance_mode="incremental", max_skew=1.3, min_objects=256)
        for b in range(3):
            ids = np.arange(0, 6000, 4)[200 * b:200 * (b + 1)]
            f.delete_batch(X[ids], ids)
            f.maintenance()
        for _ in range(4):
            f.maintenance()
        eng = StreamingEngine(smtree.bulk_build(X, capacity=16, device=dev), max_batch=256)
        eng.delete_batch(X[:700], np.arange(700))
        eng.insert_batch(X[:300] + 1e-3, 9000 + np.arange(300))
        d, i = pinned_knn(tuple(f.trees), torch.from_numpy(X[:16] + 0.01).to(dev), k=5,
                          max_frontier=64)
        runs.append((tree_digest(f.trees), f.owner, f.n_migration_steps,
                     tree_digest(eng.tree), d.cpu(), i.cpu()))
    (a, b) = runs
    assert a[2] > 0 and a[:4] == b[:4]
    assert torch.equal(a[4], b[4]) and torch.equal(a[5], b[5])


def _qkv(rng, dev, b, h, hk, sq, sk, d, dtype):
    t = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32)).to(dev, dtype)
    return t(b, h, sq, d), t(b, hk, sk, d), t(b, hk, sk, d)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hk,sq,sk,d", [
    (1, 2, 2, 128, 128, 64), (2, 4, 2, 128, 256, 64), (1, 8, 1, 100, 100, 32),
    (1, 2, 2, 257, 257, 128), (1, 16, 2, 300, 300, 128), (2, 4, 4, 33, 70, 16),
    (1, 2, 1, 65, 65, 256), (1, 2, 2, 9, 200, 96),
    # the LM's prefill shape [4, 16, 2048, 128] with b and h cut
    (1, 4, 4, 2048, 2048, 128),
    # one row either side of the query-tile edges (64 rows a warpgroup,
    # 128 f32 / 256 bf16 a block) and the key-tile edges (32 f32, 64 bf16)
    (1, 2, 1, 63, 129, 128), (1, 2, 1, 65, 127, 64), (1, 2, 1, 129, 191, 128),
    # rows of 50 elements: not a multiple of 16 bytes in either dtype
    (1, 3, 1, 70, 90, 50),
    # whisper-tiny's three attentions with b cut: the encoder over 1,500
    # frames, the decoder's 448 positions, the cross-attention onto the frames
    (1, 6, 6, 1500, 1500, 64), (1, 6, 6, 448, 448, 64), (1, 6, 6, 448, 1500, 64)])
def test_flash_kernel_matches_plain(cuda, b, h, hk, sq, sk, d, causal, dtype, tol):
    rng = np.random.default_rng(b * 7 + sq + sk + d)
    q, k, v = _qkv(rng, cuda, b, h, hk, sq, sk, d, dtype)
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, causal=causal)
    want = flash_attention_torch(q, k, v, causal=causal)
    assert flash_attention_fwd.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_large_logits(cuda, causal, dtype, tol):
    """q scaled by 8: logits of tens, so the online rescale and the hi/lo
    split of the f32 path see large values."""
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, cuda, 1, 4, 2, 300, 300, 128, dtype)
    q = q * 8
    got = flash_attention_fwd(q, k, v, causal=causal)
    want = flash_attention_torch(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_kernel_non_causal_longer_queries_and_refusals(cuda):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, cuda, 1, 4, 2, 150, 40, 64, torch.float32)
    torch.testing.assert_close(flash_attention_fwd(q, k, v, causal=False),
                               flash_attention_torch(q, k, v, causal=False),
                               rtol=2e-4, atol=2e-4)
    before = flash_attention_fwd.launches
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, v, causal=True)            # causal sq > sk
    with pytest.raises(RuntimeError):
        flash_attention_fwd(q.requires_grad_(), k, v, causal=False)
    q2, k2, v2 = _qkv(rng, cuda, 1, 2, 2, 8, 8, 264, torch.float32)
    with pytest.raises(ValueError):
        flash_attention_fwd(q2, k2, v2)                       # d > 256
    with pytest.raises(TypeError):
        flash_attention_fwd(q2[..., :64].contiguous(), k2[..., :64].contiguous().half(),
                            v2[..., :64].contiguous())
    assert flash_attention_fwd.launches == before


@pytest.mark.parametrize("metric", ["d_inf", "sqeuclidean", "ip"])
@pytest.mark.parametrize("nq,ne,d", [(32, 48, 16), (100, 130, 20), (7, 257, 96)])
def test_distance_prune_kernel_matches_plain(cuda, metric, nq, ne, d):
    rng = np.random.default_rng(nq * 31 + ne)
    q = torch.from_numpy(rng.random((nq, d), np.float32)).to(cuda)
    e = torch.from_numpy(rng.random((ne, d), np.float32)).to(cuda)
    lo, hi = {"ip": (-0.2 * d, -0.05 * d), "sqeuclidean": (0.1 * d ** 0.5, 0.35 * d ** 0.5),
              "d_inf": (0.0, 0.6)}[metric]
    r_q = torch.from_numpy(rng.uniform(lo, hi, nq).astype(np.float32)).to(cuda)
    r_e = torch.from_numpy(rng.uniform(lo, hi, ne).astype(np.float32)).to(cuda)
    before = pairwise_distance_prune.launches
    gd, gm = pairwise_distance_prune(q, e, r_q, r_e, metric)
    wd, wm = pairwise_distance_prune_torch(q, e, r_q, r_e, metric)
    assert pairwise_distance_prune.launches == before + 1
    assert gm.dtype == torch.bool
    torch.testing.assert_close(gd, wd, rtol=1e-5, atol=1e-5)
    true_d = wd.clamp_min(0).sqrt() if metric == "sqeuclidean" else wd
    decided = (true_d - (r_q[:, None] + r_e[None, :])).abs() > 1e-6
    assert torch.equal(gm[decided], wm[decided])
    assert gm[decided].any() and (~gm[decided]).any()


@pytest.mark.parametrize("metric", ["d_inf", "sqeuclidean", "ip"])
def test_distance_prune_kernel_boundary_is_inclusive(cuda, metric):
    offsets = torch.tensor([0.25, 0.5, 1.0, 2.0], device=cuda)
    q = torch.zeros((8, 32), device=cuda)
    e = torch.zeros((4, 32), device=cuda)
    e[:, 0] = offsets
    dist = torch.zeros(4, device=cuda) if metric == "ip" else offsets
    r_q = torch.full((8,), float(dist[0]) * 0.5, device=cuda)
    r_e = dist - float(dist[0]) * 0.5
    _, mask = pairwise_distance_prune(q, e, r_q, r_e, metric)
    assert bool(mask.all())


def test_lm_forward_through_the_flash_kernel_matches_plain(cuda):
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M
    cfg = smoke_config("qwen2.5-3b")
    params = M.init_params(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 70), device=cuda)
    before = flash_attention_fwd.launches
    got, _ = M.forward(params, cfg, {"tokens": toks})
    assert flash_attention_fwd.launches == before + cfg.n_layers
    want, _ = M.forward(params, cfg, {"tokens": toks}, _attention=flash_attention_torch)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_knnlm_retrieval_kernel_matches_plain_descent(cuda, metric):
    from repro_torch.serve.knnlm import KnnLmConfig, KnnLmDatastore
    rng = np.random.default_rng(11)
    keys = rng.standard_normal((3000, 384)).astype(np.float32)
    store = KnnLmDatastore(KnnLmConfig(metric=metric), 384, device=cuda)
    store.build(keys, rng.integers(0, 500, 3000).astype(np.int32))
    q = torch.from_numpy(keys[:16] + 0.05).to(cuda)
    before = frontier_scores.wide_launches
    got = store.retrieve(q)
    assert frontier_scores.wide_launches > before
    want = store.retrieve(q, _scorer=frontier_scores_torch)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert store.evict_before(100) == 100 and store.engine.validate()
    lp = store.knn_logits(q, 500)
    assert lp.shape == (16, 500) and bool(torch.isfinite(lp).all())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("sq", [256, 2048])
def test_flash_kernel_at_jambas_gqa_shape(cuda, sq, dtype, tol):
    """jamba's attention: 32 query heads over 8 KV heads, d 128, causal
    (the model repeats K/V to the query heads before the kernel; the
    kernel's own GQA form is held here too)."""
    rng = np.random.default_rng(sq)
    q, k, v = _qkv(rng, cuda, 1, 32, 8, sq, sq, 128, dtype)
    for kk, vv in ((k, v), (k.repeat_interleave(4, 1), v.repeat_interleave(4, 1))):
        got = flash_attention_fwd(q, kk, vv, causal=True)
        want = flash_attention_torch(q, kk, vv, causal=True)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _family_pair(arch, dev):
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M
    cfg = smoke_config(arch)
    cpu = M.init_params(cfg, 0, device="cpu")
    card = M.init_params(cfg, 0, device="cpu").to(dev)
    return cfg, cpu, card


@pytest.mark.parametrize("capacity", [None, 3])
def test_moe_on_card_matches_cpu(cuda, capacity):
    """``moe_apply`` on the card: the CPU's routing exactly, y and the aux
    values within 1e-4."""
    from repro_torch.models.moe import moe_apply
    cfg, cpu, card = _family_pair("qwen2-moe-a2.7b", cuda)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 40, cfg.d_model)).astype(np.float32))
    r_cpu, r_card = [], []
    want, waux = moe_apply(cpu.blocks[0].ffn, cfg, x, capacity, _routing=r_cpu)
    got, aux = moe_apply(card.blocks[0].ffn, cfg, x.to(cuda), capacity, _routing=r_card)
    assert torch.equal(r_card[0]["gate_i"].cpu(), r_cpu[0]["gate_i"])
    assert torch.equal(r_card[0]["keep"].cpu(), r_cpu[0]["keep"])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for k in waux:
        torch.testing.assert_close(aux[k].cpu(), waux[k], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s,chunk", [(19, 4), (300, 256)])
def test_mamba_on_card_matches_cpu(cuda, s, chunk):
    """The chunked scan and the decode recurrence on the card against the
    CPU within 1e-4, caches included."""
    from repro_torch.models import ssm
    cfg, cpu, card = _family_pair("jamba-v0.1-52b", cuda)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, s, cfg.d_model)).astype(np.float32))
    want = ssm.mamba_apply(cpu.blocks[0].mixer, cfg, x, chunk=chunk)
    got = ssm.mamba_apply(card.blocks[0].mixer, cfg, x.to(cuda), chunk=chunk)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    c_cpu = ssm.mamba_init_cache(cfg, 2, torch.float32, "cpu")
    c_card = ssm.mamba_init_cache(cfg, 2, torch.float32, cuda)
    for t in range(6):
        w, c_cpu = ssm.mamba_decode(cpu.blocks[0].mixer, cfg, x[:, t:t + 1], c_cpu)
        g, c_card = ssm.mamba_decode(card.blocks[0].mixer, cfg, x[:, t:t + 1].to(cuda), c_card)
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)
        for k in c_cpu:
            torch.testing.assert_close(c_card[k].cpu(), c_cpu[k], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-v0.1-52b"])
def test_family_forward_and_decode_on_card_match_cpu(cuda, arch):
    """The whole smoke model on the card (the flash kernel in the forward)
    against the CPU: logits and aux within 1e-4, decode steps too."""
    from repro_torch.models import model as M
    cfg, cpu, card = _family_pair(arch, cuda)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 70)))
    before = flash_attention_fwd.launches
    got, aux = M.forward(card, cfg, {"tokens": toks.to(cuda)})
    n_attn = sum(k.startswith("attn") for k in cfg.block_pattern) * cfg.n_periods
    assert flash_attention_fwd.launches == before + n_attn
    want, waux = M.forward(cpu, cfg, {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for k in waux:
        torch.testing.assert_close(aux[k].cpu(), waux[k], rtol=1e-4, atol=1e-4)
    c_cpu = M.init_cache(cfg, 2, 8, device="cpu")
    c_card = M.init_cache(cfg, 2, 8, device=cuda)
    for pos in range(8):
        w, c_cpu = M.decode_step(cpu, cfg, toks[:, pos], c_cpu, pos)
        g, c_card = M.decode_step(card, cfg, toks[:, pos].to(cuda), c_card, pos)
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)
