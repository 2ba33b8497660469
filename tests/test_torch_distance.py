"""Port parity: the plain pairwise distance and the one-device flat scan
against the JAX package.

``pairwise_distance`` (plain version on CPU tensors) against
``pairwise_distance_pallas(..., interpret=True)``: d_inf bitwise,
sqeuclidean/ip within 1e-5 (the tolerance of tests/test_distance_kernel.py,
which allows another summation order).  ``brute_force_knn`` against the
JAX one on a one-device mesh, bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.core.distributed import brute_force_knn as jax_brute  # noqa: E402
from repro.kernels.distance import pairwise_distance_pallas  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.core.distributed import brute_force_knn  # noqa: E402
from repro_torch.data.datagen import clustered  # noqa: E402
from repro_torch.kernels.distance import (pairwise_distance,  # noqa: E402
                                          pairwise_distance_torch)

SHAPES = [(8, 8, 4), (100, 130, 20), (1, 257, 96), (33, 7, 160)]


@pytest.mark.parametrize("nq,ne,d", SHAPES)
@pytest.mark.parametrize("metric", ["d_inf", "sqeuclidean", "ip"])
def test_plain_distance_vs_pallas_interpret(metric, nq, ne, d):
    rng = np.random.default_rng(nq * 1000 + ne + d)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    e = rng.normal(size=(ne, d)).astype(np.float32)
    want = np.asarray(pairwise_distance_pallas(jnp.asarray(q), jnp.asarray(e),
                                               metric=metric, interpret=True))
    got = pairwise_distance(torch.from_numpy(q), torch.from_numpy(e), metric)
    assert got.dtype == torch.float32 and got.shape == (nq, ne)
    if metric == "d_inf":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bf16_inputs_are_upcast():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(9, 20)).astype(np.float32)).bfloat16()
    e = torch.from_numpy(rng.normal(size=(31, 20)).astype(np.float32)).bfloat16()
    got = pairwise_distance(q, e, "d_inf")
    want = pairwise_distance(q.float(), e.float(), "d_inf")
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_plain_version_chunks_without_changing_values(monkeypatch):
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.random((13, 20), dtype=np.float32))
    e = torch.from_numpy(rng.random((501, 20), dtype=np.float32))
    whole = pairwise_distance_torch(q, e, "sqeuclidean")
    from repro_torch.kernels import distance
    monkeypatch.setattr(distance, "_PLAIN_CHUNK_ELEMS", 13 * 20 * 7)
    assert torch.equal(pairwise_distance_torch(q, e, "sqeuclidean"), whole)


@pytest.mark.parametrize("metric", ["l2", "l1", "cosine"])
def test_metric_outside_the_kernel_set_raises(metric):
    x = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="d_inf"):
        pairwise_distance(x, x, metric)


@pytest.mark.parametrize("metric", ["d_inf", "sqeuclidean"])
def test_brute_force_knn_bitwise_vs_jax(metric):
    X = clustered(3000, dims=20, seed=5)
    X = np.vstack([X, X[:40]])                      # duplicates: tie order
    Q = (X[100:132] + 0.004).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("model",))
    jd, ji = jax_brute(jnp.asarray(X), mesh, jnp.asarray(Q), k=8, metric=metric)
    td, ti = brute_force_knn(torch.from_numpy(X), Q, k=8, metric=metric,
                             device="cpu")
    if metric == "d_inf":
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    else:
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


def test_brute_force_knn_chunked_scan_keeps_tie_order(monkeypatch):
    base = np.random.default_rng(6).random((50, 6)).astype(np.float32)
    X = np.repeat(base, 5, axis=0)                  # every distance five times
    Q = base[:10] + 0.01
    whole = brute_force_knn(torch.from_numpy(X), Q, k=12, device="cpu")
    monkeypatch.setattr(distributed, "_SCAN_ELEMS", 10 * 17)  # 17-entry chunks
    chunked = brute_force_knn(torch.from_numpy(X), Q, k=12, device="cpu")
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])
    with pytest.raises(ValueError, match="k must be"):
        brute_force_knn(torch.from_numpy(X), Q, k=len(X) + 1, device="cpu")


def test_brute_force_knn_runs_on_the_device_it_is_given(monkeypatch):
    X = clustered(400, dims=5, seed=8)
    Q = X[:6] + 0.01
    d, i = brute_force_knn(X, Q, k=4, device="cpu")          # numpy in
    assert d.device.type == i.device.type == "cpu"
    assert torch.equal(i[:, 0], torch.arange(6))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        brute_force_knn(X, Q, k=4)                            # None = the card
