"""Port parity: repro_torch.core.metric against repro.core.metric, bitwise.

The reference's numpy path is the oracle; the port's metric must match it
bit for bit on numpy arrays and on torch tensors (the fixed-association
``_sum_last`` fold and a correctly rounded sqrt make that possible).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401  (both sides in one process; JAX stays on the CPU)

from repro.core import metric as ref  # noqa: E402
from repro_torch.core import metric as port  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

METRICS = ["d_inf", "l2", "l1"]
DIMS = [1, 2, 3, 7, 8, 13, 20, 33]


def _pairs(seed, dim, n=257):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    y = rng.normal(size=(n, dim)).astype(np.float32)
    # adversarial rows: equal vectors, huge and tiny magnitudes, exact ties
    y[0] = x[0]
    x[1] *= 1e6
    y[2] *= 1e-6
    y[3] = x[3] + np.float32(0.5)
    return x, y


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("metric", METRICS)
def test_metric_bitwise_numpy_and_torch(metric, dim):
    x, y = _pairs(dim, dim)
    want = ref.get_metric(metric)(x, y)
    got_np = port.get_metric(metric)(x, y)
    got_t = port.get_metric(metric)(torch.from_numpy(x), torch.from_numpy(y))
    assert got_t.dtype == torch.float32
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)


@pytest.mark.parametrize("metric", METRICS)
def test_metric_broadcasting_and_truncation(metric):
    rng = np.random.default_rng(1)
    q = rng.random((5, 1, 1, 11), dtype=np.float32)
    e = rng.random((5, 4, 6, 11), dtype=np.float32)
    want = ref.get_metric(metric)(q, e, n_dims=7)
    got = port.get_metric(metric)(torch.from_numpy(q), torch.from_numpy(e), n_dims=7)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        port.pairwise(metric, torch.from_numpy(q[:, 0, 0]),
                      torch.from_numpy(e[0, 0])).numpy(),
        ref.pairwise(metric, q[:, 0, 0], e[0, 0]))


def test_l2_sqrt_is_correctly_rounded():
    """torch's vectorised f32 sqrt on the CPU is an ulp off for a fraction
    of inputs; the port's l2 must still equal numpy's IEEE sqrt everywhere."""
    rng = np.random.default_rng(2)
    x = rng.random((200_000, 1), dtype=np.float32) * 4
    zero = np.zeros_like(x)
    got = port.l2(torch.from_numpy(x), torch.from_numpy(zero)).numpy()
    np.testing.assert_array_equal(got, ref.l2(x, zero))


def test_sum_last_association_matches_reference():
    rng = np.random.default_rng(3)
    for n in range(0, 40):
        x = (rng.normal(size=(3, n)) * 10.0 ** rng.integers(-4, 5, size=(3, n))
             ).astype(np.float32)
        np.testing.assert_array_equal(port._sum_last(torch.from_numpy(x)).numpy(),
                                      ref._sum_last(x))


def test_unknown_metric_raises():
    with pytest.raises(KeyError, match="unknown metric"):
        port.get_metric("cosine")
