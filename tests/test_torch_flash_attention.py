"""The port's attention against the JAX package on the CPU.

``flash_attention_torch`` (the plain version of the CUDA flash kernel) and
``chunked_attention`` are held against the JAX flash kernel in interpret
mode (``ops.attention(impl="interpret")``) and its oracle, on the cases of
``tests/test_flash_attention.py`` (GQA, MQA, lengths that are no multiple of
a block, ``sk > sq``), causal and not: 2e-4 in f32, 3e-2 in bf16 (the
tolerances of the reference's own tests).  The CUDA kernel itself is held
against the plain version on the card (``tests/test_torch_kernels_gpu.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.attention_xla import decode_attention as jax_decode  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.attention_plain import (NEG_INF,  # noqa: E402
                                                 chunked_attention,
                                                 decode_attention)
from repro_torch.kernels.flash_attention import (flash_attention_fwd,  # noqa: E402
                                                 flash_attention_torch)

CASES = [
    # b, h, hk, sq, sk, d
    (1, 2, 2, 128, 128, 64),
    (2, 4, 2, 128, 256, 64),     # GQA g=2, sk > sq (causal offset)
    (1, 8, 1, 100, 100, 32),     # MQA, no block multiple
    (1, 2, 2, 257, 257, 128),
]
DTYPES = [("float32", 2e-4), ("bfloat16", 3e-2)]


def _qkv(b, h, hk, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, d)).astype(np.float32),
            rng.normal(size=(b, hk, sk, d)).astype(np.float32),
            rng.normal(size=(b, hk, sk, d)).astype(np.float32))


def _both(arrays, dtype):
    j = [jnp.asarray(a).astype(dtype) for a in arrays]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return j, t


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hk,sq,sk,d", CASES)
def test_plain_versions_match_jax_kernel(b, h, hk, sq, sk, d, causal, dtype, tol):
    (jq, jk, jv), (q, k, v) = _both(_qkv(b, h, hk, sq, sk, d), dtype)
    want = jops.attention(jq, jk, jv, causal=causal, impl="interpret")
    for fn in (flash_attention_torch, chunked_attention):
        got = fn(q, k, v, causal=causal)
        assert got.dtype == q.dtype and got.shape == q.shape
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hk,sq,sk,d", CASES)
def test_oracles_agree(b, h, hk, sq, sk, d, causal):
    (jq, jk, jv), (q, k, v) = _both(_qkv(b, h, hk, sq, sk, d, seed=1), "float32")
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(ref.flash_attention_ref(q, k, v, causal=causal).numpy(),
                               np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(flash_attention_torch(q, k, v, causal=causal).numpy(),
                               np.asarray(want), rtol=2e-4, atol=2e-4)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 40, 40, 16))
    before = flash_attention_fwd.launches
    want = flash_attention_torch(q, k, v, causal=True)
    assert torch.equal(flash_attention_fwd(q, k, v, causal=True), want)
    assert torch.equal(ops.attention(q, k, v, causal=True), want)
    assert flash_attention_fwd.launches == before


@pytest.mark.parametrize("chunk", [16, 64, 512])
def test_chunk_size_does_not_change_the_result(chunk):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 70, 90, 32, seed=3))
    torch.testing.assert_close(chunked_attention(q, k, v, causal=True, chunk=chunk),
                               ref.flash_attention_ref(q, k, v, causal=True),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("hk", [1, 2, 4])
def test_decode_attention_with_kv_len_matches_jax(hk):
    rng = np.random.default_rng(hk)
    b, h, S, d = 3, 4, 20, 16
    q1 = rng.normal(size=(b, h, 1, d)).astype(np.float32)
    k = rng.normal(size=(b, hk, S, d)).astype(np.float32)
    v = rng.normal(size=(b, hk, S, d)).astype(np.float32)
    kv_len = np.array([1, 7, 20], np.int32)
    want = jax_decode(jnp.asarray(q1), jnp.asarray(k), jnp.asarray(v),
                      kv_len=jnp.asarray(kv_len))
    got = decode_attention(torch.from_numpy(q1), torch.from_numpy(k),
                           torch.from_numpy(v), kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    # positions at or past kv_len do not matter
    k2, v2 = k.copy(), v.copy()
    k2[0, :, 1:] = 100.0
    v2[0, :, 1:] = -100.0
    again = decode_attention(torch.from_numpy(q1), torch.from_numpy(k2),
                             torch.from_numpy(v2), kv_len=torch.from_numpy(kv_len))
    assert torch.equal(again[0], got[0])


def test_masked_logits_are_finite():
    assert NEG_INF == -1e30
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 2, 8, 8, 16))
    out = chunked_attention(q, k, v, causal=True, chunk=4)
    assert torch.isfinite(out).all()
