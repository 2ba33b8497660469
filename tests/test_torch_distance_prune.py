"""The port's fused distance + prune mask against the JAX package on the CPU.

``pairwise_distance_prune`` (the plain version on CPU tensors, the CUDA
kernel's ``PRUNE`` epilogue on the card) against the JAX
``ops.pairwise_distance_prune`` in interpret mode (the Pallas kernel) and
its XLA reference: distances within 1e-5, masks equal wherever the
distance is not within 1e-6 of ``r_q + r_e`` (the two sides sum the
distance in different orders), and equal everywhere on the exact-boundary
rows, where equality survives.  The cases are those of
``tests/test_distance_prune_epilogue.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.distance import (pairwise_distance_prune,  # noqa: E402
                                          pairwise_distance_prune_torch)

METRICS = ["d_inf", "sqeuclidean", "ip"]
IMPLS = ["interpret", "xla"]


def _true(dist, metric):
    d = np.asarray(dist, np.float64)
    return np.sqrt(np.maximum(d, 0.0)) if metric == "sqeuclidean" else d


def _inputs(nq, ne, d, metric, seed):
    rng = np.random.default_rng(seed)
    q = rng.random((nq, d), np.float32)
    e = rng.random((ne, d), np.float32)
    lo, hi = {"ip": (-0.2 * d, -0.05 * d),
              "sqeuclidean": (0.1 * d ** 0.5, 0.35 * d ** 0.5),
              "d_inf": (0.0, 0.6)}[metric]
    r_q = rng.uniform(lo, hi, nq).astype(np.float32)
    r_e = rng.uniform(lo, hi, ne).astype(np.float32)
    return q, e, r_q, r_e


def _compare(q, e, r_q, r_e, metric, impl, *, min_decided=0.95):
    jd, jm = jops.pairwise_distance_prune(*map(jnp.asarray, (q, e, r_q, r_e)),
                                          metric=metric, impl=impl)
    td, tm = pairwise_distance_prune(*map(torch.from_numpy, (q, e, r_q, r_e)), metric)
    assert tm.dtype == torch.bool and td.dtype == torch.float32
    assert td.shape == tm.shape == (len(q), len(e))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    margin = np.abs(_true(td.numpy(), metric) - (r_q[:, None] + r_e[None, :]))
    decided = margin > 1e-6
    assert decided.mean() > min_decided
    np.testing.assert_array_equal(tm.numpy()[decided], np.asarray(jm)[decided])
    return tm.numpy()[decided]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("nq,ne,d", [(32, 48, 16), (100, 130, 20), (7, 257, 96)])
def test_prune_matches_jax(nq, ne, d, metric, impl):
    mask = _compare(*_inputs(nq, ne, d, metric, nq * 31 + ne), metric, impl)
    assert mask.any() and (~mask).any()      # both populations present


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("metric", METRICS)
def test_exact_boundary_is_inclusive(metric, impl):
    d = 32
    q = np.zeros((8, d), np.float32)
    offsets = np.asarray([0.25, 0.5, 1.0, 2.0], np.float32)
    e = np.zeros((4, d), np.float32)
    e[:, 0] = offsets
    dist = np.zeros(4, np.float32) if metric == "ip" else offsets
    r_q = np.full((8,), dist[0] * 0.5, np.float32)
    r_e = (dist - dist[0] * 0.5).astype(np.float32)   # r_q + r_e == d exactly
    _, jm = jops.pairwise_distance_prune(*map(jnp.asarray, (q, e, r_q, r_e)),
                                         metric=metric, impl=impl)
    td, tm = pairwise_distance_prune(*map(torch.from_numpy, (q, e, r_q, r_e)), metric)
    assert np.asarray(jm).all() and bool(tm.all())
    np.testing.assert_array_equal(_true(td.numpy(), metric)[0], dist)


@pytest.mark.parametrize("metric", METRICS)
def test_padding_radii_never_survive(metric):
    """The TPU wrapper pads queries with r = -1 and entries with r = -inf:
    an entry with r = -inf survives for no query, and a query with r = -1
    survives only where d <= r_e - 1, the same on both sides."""
    q, e, r_q, r_e = _inputs(20, 70, 12, metric, 9)
    r_e[::3] = -np.inf
    r_q[::4] = -1.0
    for impl in IMPLS:
        _compare(q, e, r_q, r_e, metric, impl, min_decided=0.9)
    _, tm = pairwise_distance_prune(*map(torch.from_numpy, (q, e, r_q, r_e)), metric)
    assert not bool(tm[:, ::3].any())


def test_one_ulp_below_prunes_and_padding_the_radius_keeps():
    q = torch.zeros((1, 16))
    e = torch.zeros((1, 16))
    e[0, 0] = 1.0
    ulp = float(np.spacing(np.float32(1.0)))
    r_e = torch.tensor([1.0 - ulp - 0.5])
    strict = pairwise_distance_prune(q, e, torch.tensor([0.5]), r_e, "d_inf")[1]
    padded = pairwise_distance_prune(q, e, torch.tensor([0.5 + 1e-5]), r_e, "d_inf")[1]
    assert not bool(strict[0, 0]) and bool(padded[0, 0])


def test_cpu_dispatch_and_oracle():
    q, e, r_q, r_e = map(torch.from_numpy, _inputs(30, 40, 8, "sqeuclidean", 2))
    before = pairwise_distance_prune.launches
    d1, m1 = ops.pairwise_distance_prune(q, e, r_q, r_e, "sqeuclidean")
    d2, m2 = pairwise_distance_prune_torch(q, e, r_q, r_e, "sqeuclidean")
    assert torch.equal(d1, d2) and torch.equal(m1, m2)
    assert pairwise_distance_prune.launches == before
    torch.testing.assert_close(d1, ref.pairwise_distance_ref(q, e, "sqeuclidean"),
                               rtol=1e-5, atol=1e-5)
    want = ref.prune_mask_ref(d1.clamp_min(0).sqrt(), r_q, r_e)
    assert (m1 == want).float().mean() > 0.99
    with pytest.raises(ValueError):
        pairwise_distance_prune(q, e, r_q, r_e, "l1")
