"""Port parity: the plain frontier scorer against the reference's Pallas
kernel (interpret mode) and XLA gather path, bitwise on all four outputs.

``frontier_scores_torch`` is what the CUDA kernel is held to on the card
(tests/test_torch_kernels_gpu.py), so this file closes the chain
kernel == plain == JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.frontier import (_PRUNE_PAD as REF_PAD,  # noqa: E402
                                    frontier_scores_pallas,
                                    frontier_scores_xla)
from repro_torch.kernels.frontier import (_PRUNE_PAD,  # noqa: E402
                                          frontier_scores,
                                          frontier_scores_torch)

METRICS = ["d_inf", "l2", "l1"]
OUT_NAMES = ("dmax", "score", "leaf_d", "dq")


def _inputs(seed, N=40, cap=16, dim=10, b=8, w=5):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(N, cap, dim)).astype(np.float32)
    radius = np.abs(rng.normal(size=(N, cap))).astype(np.float32)
    valid = rng.random((N, cap)) < 0.8
    is_leaf = rng.random(N) < 0.5
    iv, lv = valid & ~is_leaf[:, None], valid & is_leaf[:, None]
    fids = rng.integers(-1, N, size=(b, w)).astype(np.int32)
    fids[0, :] = -1                      # fully-done query
    fids[1, :] = 0                       # duplicated node
    fids[2, 0] = N - 1                   # last row
    queries = rng.normal(size=(b, dim)).astype(np.float32)
    pdist = np.abs(rng.normal(size=(N, cap))).astype(np.float32)
    qpd = np.abs(rng.normal(size=(b, w))).astype(np.float32)
    qpd[fids < 0] = np.inf               # empty slots carry +inf
    rq = np.abs(rng.normal(size=(b,))).astype(np.float32)
    return (fids, queries, vecs, radius, iv, lv), dict(pdist=pdist, qpd=qpd, rq=rq)


def _both(args, filt, metric):
    """(port outputs as numpy, pallas outputs, xla outputs) on one input."""
    port = frontier_scores_torch(*(torch.from_numpy(a) for a in args),
                                 metric=metric,
                                 **{k: torch.from_numpy(v) for k, v in filt.items()})
    jargs = [jnp.asarray(a) for a in args]
    jfilt = {k: jnp.asarray(v) for k, v in filt.items()}
    pal = frontier_scores_pallas(*jargs, metric=metric, interpret=True, **jfilt)
    xla = frontier_scores_xla(*jargs, metric=metric, **jfilt)
    return [o.numpy() for o in port], pal, xla


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_plain_scorer_bitwise_vs_pallas_and_xla(metric, prune):
    args, filt = _inputs(3 if prune else 0)
    port, pal, xla = _both(args, filt if prune else {}, metric)
    for p, a, x, name in zip(port, pal, xla, OUT_NAMES):
        assert p.dtype == np.float32 and p.shape == (8, 5, 16)
        np.testing.assert_array_equal(p, np.asarray(a), err_msg=f"{metric}/{name}/pallas")
        np.testing.assert_array_equal(p, np.asarray(x), err_msg=f"{metric}/{name}/xla")


@pytest.mark.parametrize("metric", ["d_inf", "l2"])
def test_odd_dims_and_wide_pages(metric):
    args, filt = _inputs(11, N=12, cap=32, dim=7, b=4, w=6)
    port, pal, xla = _both(args, filt, metric)
    for p, a, x in zip(port, pal, xla):
        np.testing.assert_array_equal(p, np.asarray(a))
        np.testing.assert_array_equal(p, np.asarray(x))


def test_empty_frontier_emits_inf():
    args, _ = _inputs(1, N=8, cap=4, dim=6, b=3, w=4)
    fids = np.full((3, 4), -1, np.int32)
    out = frontier_scores(torch.from_numpy(fids),
                          *(torch.from_numpy(a) for a in args[1:]), metric="l2")
    assert all(torch.isposinf(o).all() for o in out)


def test_prune_boundary_is_inclusive():
    """|qpd - pdist| == rq + r keeps the entry (as the reference does);
    a gap clearly above the pad drops it."""
    assert _PRUNE_PAD == REF_PAD
    cap, dim = 4, 6
    pdist = np.asarray([[1.0, 0.75, 1.0 - _PRUNE_PAD / 2, 0.875]], np.float32)
    args = (np.zeros((1, 1), np.int32), np.zeros((1, dim), np.float32),
            np.zeros((1, cap, dim), np.float32),
            np.asarray([[0.0, 0.25, 0.0, 0.0]], np.float32),
            np.ones((1, cap), bool), np.zeros((1, cap), bool))
    filt = dict(pdist=pdist, qpd=np.asarray([[1.5]], np.float32),
                rq=np.asarray([0.5], np.float32))
    port, pal, xla = _both(args, filt, "d_inf")
    want = [True, True, True, False]
    np.testing.assert_array_equal(np.isfinite(port[0])[0, 0], want)
    np.testing.assert_array_equal(np.isfinite(np.asarray(pal[0]))[0, 0], want)
    np.testing.assert_array_equal(np.isfinite(np.asarray(xla[0]))[0, 0], want)


def test_cpu_dispatch_takes_plain_version_and_counts_nothing():
    args, filt = _inputs(4)
    t = [torch.from_numpy(a) for a in args]
    before = (frontier_scores.launches, frontier_scores.pruned_launches)
    a = frontier_scores(*t, metric="l1",
                        **{k: torch.from_numpy(v) for k, v in filt.items()})
    b = frontier_scores_torch(*t, metric="l1",
                              **{k: torch.from_numpy(v) for k, v in filt.items()})
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (frontier_scores.launches, frontier_scores.pruned_launches) == before


def test_partial_prune_args_raise():
    args, filt = _inputs(5)
    with pytest.raises(ValueError, match="pdist"):
        frontier_scores(*(torch.from_numpy(a) for a in args), metric="d_inf",
                        qpd=torch.from_numpy(filt["qpd"]))


def test_unknown_metric_raises():
    args, _ = _inputs(6)
    with pytest.raises(KeyError):
        frontier_scores(*(torch.from_numpy(a) for a in args), metric="cosine")


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("cap", [65, 97, 128])
def test_pages_wider_than_64_entries(metric, prune, cap):
    """Pages above 64 entries, which the CUDA kernel scores as segments of
    at most 64: the plain version the kernel is held to, against both JAX
    paths."""
    args, filt = _inputs(cap + prune, N=9, cap=cap, dim=6, b=5, w=4)
    port, pal, xla = _both(args, filt if prune else {}, metric)
    for p, a, x, name in zip(port, pal, xla, OUT_NAMES):
        assert p.shape == (5, 4, cap)
        np.testing.assert_array_equal(p, np.asarray(a), err_msg=f"{metric}/{name}/pallas")
        np.testing.assert_array_equal(p, np.asarray(x), err_msg=f"{metric}/{name}/xla")
    live = np.isfinite(port[0]) | np.isfinite(port[2])
    assert live[..., 64:].any()                  # entries past the first segment score


@pytest.mark.parametrize("metric", METRICS)
def test_knn_on_a_capacity_96_tree_bitwise_vs_jax(metric):
    """The descent over pages of 96 entries (two segments on the card),
    bitwise against the JAX package's ``knn``."""
    from repro.core import smtree as J
    from repro_torch.core import smtree as T
    from repro_torch.core.convert import tree_from_numpy
    from repro_torch.data.datagen import clustered, uniform
    X = clustered(2000, dims=6, seed=8)
    jt = J.bulk_build(X, capacity=96, metric=metric)
    tt = tree_from_numpy({f: np.asarray(getattr(jt, f)) for f in T.ARRAY_FIELDS},
                         {f: getattr(jt, f) for f in T.META_FIELDS}, "cpu")
    assert tt.vecs.shape[1] == 96 and int(tt.height) >= 2
    Q = np.vstack([uniform(6, dims=6, seed=9), X[:6] + 0.003]).astype(np.float32)
    for k, F in ((1, 64), (8, 128)):
        jr = J.knn(jt, Q, k=k, max_frontier=F, impl="xla")
        tr = T.knn(tt, Q, k=k, max_frontier=F)
        for f in ("dists", "ids", "page_hits", "dist_evals", "overflow"):
            np.testing.assert_array_equal(getattr(tr, f).numpy(), np.asarray(getattr(jr, f)),
                                          err_msg=f"{metric} k={k} F={F} {f}")
