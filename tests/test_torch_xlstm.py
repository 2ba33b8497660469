"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
package on the CPU.

The same seeded numpy inputs go through ``repro.models.xlstm`` and the
port; block weights are the JAX init of the smoke xlstm-1.3b (14 mLSTM and
2 sLSTM layers, d_model 64, 4 heads) carried over by ``params_from_jax``
(layer 0 is an mLSTM block, layer 7 an sLSTM block).  Tolerance 1e-4, as
in tests/test_torch_models.py: the two frameworks sum in different
orders (the stabiliser's scan tree among them).
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.all_archs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

TOL = 1e-4
ARCH = "xlstm-1.3b"


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(torch.as_tensor(got).float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=msg)


def _gates(rng, b, s, H):
    log_f = np.array(jax.nn.log_sigmoid(rng.normal(3.0, 1.5, (b, s, H))), np.float32)
    log_i = rng.normal(0.0, 2.0, (b, s, H)).astype(np.float32)
    return log_f, log_i


@pytest.mark.parametrize("s", [37, 512, 2048])
def test_stabiliser_matches_jax(s):
    rng = np.random.default_rng(s)
    log_f, log_i = _gates(rng, 2, s, 4)
    m0 = rng.normal(0.0, 1.0, (2, 4)).astype(np.float32)
    want = JX._stabiliser(jnp.asarray(log_f), jnp.asarray(log_i), jnp.asarray(m0))
    got = X._stabiliser(*map(torch.from_numpy, (log_f, log_i, m0)))
    _close(got, want)
    # against the recurrence it stands for, one step at a time
    m, seq = m0.astype(np.float64), []
    for t in range(s):
        m = np.maximum(m + log_f[:, t], log_i[:, t])
        seq.append(m)
    _close(got, np.stack(seq, 1))


@pytest.mark.parametrize("s,chunk", [(37, 16), (64, 16), (512, 256)])
def test_mlstm_cell_matches_jax(s, chunk):
    """Padded (37 = 2 x 16 + 5) and whole chunks, from a non-zero state:
    h and the final (C, n, m)."""
    b, H, dh = 2, 3, 8
    rng = np.random.default_rng(s + chunk)
    q, k, v = (rng.normal(size=(b, H, s, dh)).astype(np.float32) for _ in range(3))
    log_f, log_i = _gates(rng, b, s, H)
    C0 = rng.normal(0, 0.1, (b, H, dh, dh)).astype(np.float32)
    n0 = rng.normal(0, 0.1, (b, H, dh)).astype(np.float32)
    m0 = rng.normal(0, 0.5, (b, H)).astype(np.float32)
    arrays = (q, k, v, log_f, log_i)
    jh, (jC, jn, jm) = JX.mlstm_cell(*map(jnp.asarray, arrays),
                                     tuple(map(jnp.asarray, (C0, n0, m0))), chunk=chunk)
    h, (C, n, m) = X.mlstm_cell(*map(torch.from_numpy, arrays),
                                tuple(map(torch.from_numpy, (C0, n0, m0))), chunk=chunk)
    assert h.shape == (b, H, s, dh) and h.dtype == torch.float32
    for name, g, w in (("h", h, jh), ("C", C, jC), ("n", n, jn), ("m", m, jm)):
        _close(g, w, msg=name)


@pytest.mark.parametrize("H,dh", [(1, 8), (4, 3), (2, 16)])
def test_slstm_scan_matches_jax(H, dh):
    """``rh`` head-major, then z, i, f, o as contiguous slices: at H > 1 and
    dh > 1 a gate-major reshape would give other numbers."""
    D = H * dh
    cfg = dataclasses.replace(smoke_config(ARCH), d_model=D, n_heads=H)
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), d_model=D, n_heads=H)
    jp = JX.slstm_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    p = X.SLSTM(*(torch.from_numpy(np.array(jp[k])) for k in ("w", "b", "r")),
                None, None, None)
    rng = np.random.default_rng(H * 100 + dh)
    b, s = 2, 19
    wx = rng.normal(size=(b, s, 4 * D)).astype(np.float32)
    state = tuple(rng.normal(0, 0.3, (b, D)).astype(np.float32) for _ in range(4))
    jh, jstate = JX._slstm_scan(jp, jcfg, jnp.asarray(wx), tuple(map(jnp.asarray, state)))
    h, new = X._slstm_scan(p, cfg, torch.from_numpy(wx), tuple(map(torch.from_numpy, state)))
    _close(h, jh)
    for name, g, w in zip("cnhm", new, jstate):
        _close(g, w, msg=name)


def _x(cfg, b=2, s=21, seed=0):
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)


def test_mlstm_apply_and_decode_match_jax(pair):
    jcfg, jparams, cfg, params = pair
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["mlstm"])
    p = params.blocks[0].mixer
    assert params.blocks[0].kind == "mlstm" and isinstance(p, X.MLSTM)
    x = _x(cfg)
    _close(X.mlstm_apply(p, cfg, torch.from_numpy(x), chunk=8),
           JX.mlstm_apply(jp, jcfg, jnp.asarray(x), chunk=8))
    jc, c = JX.mlstm_init_cache(jcfg, 2, jnp.float32), X.mlstm_init_cache(cfg, 2,
                                                                          torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in c.items()} == {k: v.shape for k, v in jc.items()}
    for t in range(6):
        jy, jc = JX.mlstm_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jc)
        y, c = X.mlstm_decode(p, cfg, torch.from_numpy(x[:, t:t + 1]), c)
        _close(y, jy, msg=f"step {t}")
        for k in c:
            _close(c[k], jc[k], msg=f"step {t} {k}")


def test_slstm_apply_and_decode_match_jax(pair):
    jcfg, jparams, cfg, params = pair
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][7]["slstm"])
    p = params.blocks[7].mixer
    assert params.blocks[7].kind == "slstm" and isinstance(p, X.SLSTM)
    x = _x(cfg, seed=1)
    _close(X.slstm_apply(p, cfg, torch.from_numpy(x)), JX.slstm_apply(jp, jcfg, jnp.asarray(x)))
    jc, c = JX.slstm_init_cache(jcfg, 2, jnp.float32), X.slstm_init_cache(cfg, 2,
                                                                          torch.float32, "cpu")
    for t in range(6):
        jy, jc = JX.slstm_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jc)
        y, c = X.slstm_decode(p, cfg, torch.from_numpy(x[:, t:t + 1]), c)
        _close(y, jy, msg=f"step {t}")
        for k in "cnhm":
            _close(c[k], jc[k], msg=f"step {t} {k}")


def test_blocks_decode_agrees_with_apply(pair):
    """Chunk-parallel against recurrent, per block: the one-step decode of
    a sequence gives the block's full-sequence output."""
    _, _, cfg, params = pair
    x = torch.from_numpy(_x(cfg, s=13, seed=2))
    for layer, apply, decode, init in ((0, X.mlstm_apply, X.mlstm_decode, X.mlstm_init_cache),
                                       (7, X.slstm_apply, X.slstm_decode, X.slstm_init_cache)):
        p = params.blocks[layer].mixer
        full = apply(p, cfg, x) if layer else apply(p, cfg, x, chunk=4)
        c = init(cfg, 2, torch.float32, "cpu")
        for t in range(13):
            y, c = decode(p, cfg, x[:, t:t + 1], c)
            torch.testing.assert_close(y, full[:, t:t + 1], rtol=TOL, atol=TOL)


def _ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of the largest |want| (one ulp is
    2^(e - 7) for |want| in [2^e, 2^(e + 1)))."""
    want = np.asarray(want.astype(jnp.float32))
    top = float(np.abs(want).max())
    return float(np.abs(got.float().numpy() - want).max()) / 2.0 ** (np.floor(np.log2(top)) - 7)


def test_bf16_weights_convert_keep_their_f32_leaves_and_match_jax():
    """The leaves the reference makes float32 whatever the parameter dtype
    (``w_if``, ``b_if``, ``outnorm``; ``b``, ``r``, ``gnorm``) convert as
    float32, the rest as bfloat16, and the port's init makes the same.  In
    bf16 parameters and compute, measured in bf16 ulps of the largest
    |value| as tests/test_torch_models.py measures the 2-layer dense
    model's logits (within 2 there): a block rounds to bf16 several times
    in a row, and the frameworks' summation orders flip some of those
    roundings, so each block's output is held within 4 ulps (1 to 3 on six
    seeds), and the logits after all 16 layers within one ulp a layer (7
    to 9.5 on six seeds)."""
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **bf16)
    cfg = dataclasses.replace(smoke_config(ARCH), **bf16)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    f32 = {n.split(".", 3)[-1] for n, p in params.named_parameters()
           if p.dtype == torch.float32}
    assert f32 == {"w_if", "b_if", "outnorm.scale", "b", "r", "gnorm.scale"}
    mine = M.init_params(cfg, 0, device="cpu")
    shape = lambda m: {n: (tuple(p.shape), p.dtype) for n, p in m.named_parameters()}
    assert shape(mine) == shape(params)

    x = _x(cfg, s=24, seed=3)
    xb, xt = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    for layer, kind in ((0, "mlstm"), (7, "slstm")):
        jp = jax.tree.map(lambda a: a[0], jparams["blocks"][layer][kind])
        got = getattr(X, f"{kind}_apply")(params.blocks[layer].mixer, cfg, xt)
        assert got.dtype == torch.bfloat16
        assert _ulps(got, getattr(JX, f"{kind}_apply")(jp, jcfg, xb)) <= 4, kind
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, _ = M.forward(params, cfg, {"tokens": toks})
    assert got.dtype == torch.bfloat16 and _ulps(got, want) <= cfg.n_layers


def test_exact_param_count_at_full_width():
    """xlstm-1.3b on the meta device: exactly the reference's
    ``exact_param_count``, 3,609,147,728 (``cfg.param_count``, the
    reference's copy, says 3,639,533,568), and ``chip_smoke.py``'s pin of
    its L3 phase, one 8-layer period of it: the reference's count of that
    period."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.models import transformer
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    cfg = get_config(ARCH)
    meta = transformer.init_lm(cfg, torch.Generator(), "meta")
    assert M.param_count(meta) == JM.exact_param_count(jax_get_config(ARCH)) == 3_609_147_728
    assert cfg.param_count == 3_639_533_568
    period = dataclasses.replace(jax_get_config(ARCH), n_layers=8)
    assert chip_smoke.LM_FAMILIES_FULL["xlstm"]["overrides"] == {"n_layers": 8}
    assert chip_smoke.LM_FAMILIES_FULL["xlstm"]["params"] == JM.exact_param_count(period) \
        == 773_230_648
    assert [b.kind for b in meta.blocks] == (["mlstm"] * 7 + ["slstm"]) * 6
    assert all(b.norm2 is None and b.ffn is None for b in meta.blocks)
    assert X._f_up(2048) == 2816


def test_serve_loop_gives_the_jax_tokens(pair):
    """``launch/serve --arch xlstm-1.3b --knn``: the prompt fed through the
    mLSTM and sLSTM decode caches, keys of width d_model; the JAX
    package's tokens."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    argv = ["--smoke", "--arch", ARCH, "--steps", "6", "--prompt-len", "8", "--knn"]
    want = np.asarray(jserve.main(argv))
    _, _, cfg, params = pair
    args = serve.parser().parse_args(argv + ["--device", "cpu"])
    store = serve._build_store(args, cfg, "cpu")
    assert store.engine.tree.vecs.shape[-1] == cfg.d_model
    got, _ = serve.serve_loop(args, cfg, params, store)
    np.testing.assert_array_equal(got, want)
