"""The port's Mamba block (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm`` on the CPU.

Both get the same numpy weights (the JAX ``mamba_init`` of jamba's smoke
config) and inputs (numpy, seeded); outputs, decode outputs and caches
within 1e-4.  The chunked scan is checked below, at and several times
over its chunk length, so the state is carried across chunks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.all_archs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import ssm as J  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.layers import Dense  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

TOL = 1e-4
ARCH = "jamba-v0.1-52b"


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _pair(seed=0, **overrides):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **overrides)
    cfg = dataclasses.replace(smoke_config(ARCH), **overrides)
    jp = J.mamba_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    dense = lambda d: Dense(_t(d["w"]), _t(d["b"]) if "b" in d else None)
    p = ssm.Mamba(dense(jp["in_proj"]), _t(jp["conv_w"]), _t(jp["conv_b"]),
                  dense(jp["x_proj"]), dense(jp["dt_proj"]), _t(jp["A_log"]), _t(jp["D"]),
                  dense(jp["out_proj"]))
    return jcfg, jp, cfg, p


def _x(cfg, b, s, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("s", [5, 8, 29, 32])
def test_mamba_apply_matches_jax_across_chunks(s):
    """chunk=8: s below, equal to and several times the chunk (29: a
    short last chunk, which the reference pads)."""
    jcfg, jp, cfg, p = _pair()
    x = _x(cfg, 2, s)
    want = J.mamba_apply(jp, jcfg, jnp.asarray(x), chunk=8)
    got = ssm.mamba_apply(p, cfg, torch.from_numpy(x), chunk=8)
    assert got.shape == (2, s, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_mamba_chunk_length_does_not_change_the_answer():
    _, _, cfg, p = _pair()
    x = torch.from_numpy(_x(cfg, 2, 40))
    whole = ssm.mamba_apply(p, cfg, x)
    for chunk in (1, 3, 8, 16):
        torch.testing.assert_close(ssm.mamba_apply(p, cfg, x, chunk=chunk), whole,
                                   rtol=TOL, atol=TOL)


def test_mamba_decode_steps_and_caches_match_jax():
    jcfg, jp, cfg, p = _pair()
    b = 3
    xs = _x(cfg, b, 7, seed=2)
    jc = J.mamba_init_cache(jcfg, b, jnp.float32)
    c = ssm.mamba_init_cache(cfg, b, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in c.items()} == {k: v.shape for k, v in jc.items()}
    for t in range(xs.shape[1]):
        want, jc = J.mamba_decode(jp, jcfg, jnp.asarray(xs[:, t:t + 1]), jc)
        got, c = ssm.mamba_decode(p, cfg, torch.from_numpy(xs[:, t:t + 1]), c)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        for k in ("conv", "h"):
            np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]), rtol=TOL, atol=TOL,
                                       err_msg=k)
    assert c["h"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_agrees_with_the_scan(dtype):
    """Step by step through the cache gives the chunked scan's outputs; in
    bfloat16 the cache's window stays bf16 and its state f32."""
    _, _, cfg, p = _pair(compute_dtype=dtype)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(_x(cfg, 2, 19, seed=3)).to(dt)
    full = ssm.mamba_apply(p, cfg, x, chunk=4)
    c = ssm.mamba_init_cache(cfg, 2, dt, "cpu")
    tol = TOL if dtype == "float32" else 2 * 2.0 ** -7 * float(full.float().abs().max())
    for t in range(19):
        y, c = ssm.mamba_decode(p, cfg, x[:, t:t + 1], c)
        assert c["conv"].dtype == dt and c["h"].dtype == torch.float32
        torch.testing.assert_close(y.float(), full[:, t:t + 1].float(), rtol=tol, atol=tol)


def test_softplus_matches_jax():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)`` on both sides of 20."""
    v = np.linspace(-30, 40, 7001).astype(np.float32)
    got = ssm._softplus(torch.from_numpy(v)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=2 ** -22, atol=0)  # 2 f32 ulps


def test_mamba_init_shapes_and_dtypes():
    cfg = dataclasses.replace(smoke_config(ARCH), param_dtype="bfloat16")
    p = ssm.Mamba.init(cfg, torch.bfloat16, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    jp = J.mamba_init(jax.random.PRNGKey(0),
                      dataclasses.replace(jax_smoke_config(ARCH), param_dtype="bfloat16"),
                      jnp.bfloat16)
    got = {n: (tuple(t.shape), str(t.dtype).split(".")[1]) for n, t in p.named_parameters()}
    want = {".".join(k.key for k in path): (tuple(a.shape), str(a.dtype))
            for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert got == want
    # the correctly rounded log: float64's, rounded to float32
    n = cfg.ssm_state
    exact = np.log(np.arange(1, n + 1, dtype=np.float64)).astype(np.float32)
    np.testing.assert_array_equal(p.A_log.numpy(), np.broadcast_to(exact, p.A_log.shape))
    # XLA:CPU's log is an ulp off at log(7) on some hosts
    np.testing.assert_array_max_ulp(p.A_log.numpy(), np.asarray(jp["A_log"]), maxulp=1)
    assert bool((p.D == 1).all()) and bool((p.dt_proj.b == 0).all())
