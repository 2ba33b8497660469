"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper)
against the JAX package on the CPU.

The smoke whisper-tiny (2 + 2 layers, d_model 64, 4 heads, 64 decoder
positions) with the JAX init carried over by ``params_from_jax``; seeded
numpy frames [b, s_enc, 64] and tokens.  The reference runs its own
``ATTN_IMPL`` (the XLA attention on the CPU), the port its plain attention
(CPU tensors).  Tolerance 1e-4 on the encoder memory, logits and every
cache field, as in tests/test_torch_models.py.
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
from repro.launch import serve as jserve  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import encdec as E  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

TOL = 1e-4
ARCH = "whisper-tiny"
B, S_ENC, S_DEC = 2, 40, 12


def _pair(**overrides):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **overrides)
    cfg = dataclasses.replace(smoke_config(ARCH), **overrides)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _inputs(cfg, seed=0, b=B, s_enc=S_ENC, s_dec=S_DEC):
    rng = np.random.default_rng(seed)
    return {"frames": rng.normal(size=(b, s_enc, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (b, s_dec)).astype(np.int32)}


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=msg)


@pytest.mark.parametrize("n,d", [(1500, 384), (37, 64), (5, 6)])
def test_sinusoidal_positions_are_the_reference(n, d):
    got = TL.sinusoidal_positions(n, d)
    assert got.dtype == np.float32 and got.shape == (n, d)
    np.testing.assert_array_equal(got, JL.sinusoidal_positions(n, d))


def test_encode_matches_jax(pair):
    jcfg, jparams, cfg, params = pair
    frames = _inputs(cfg)["frames"]
    want = JE.encode(jparams, jcfg, jnp.asarray(frames))
    got = E.encode(params, cfg, frames)
    assert got.shape == (B, S_ENC, cfg.d_model) and got.dtype == torch.float32
    _close(got, want)


def test_forward_matches_jax(pair):
    """The encoder, then the decoder's causal self-attention and its
    cross-attention (sq = 12 < sk = 40) onto the memory, tied head."""
    jcfg, jparams, cfg, params = pair
    batch = _inputs(cfg, seed=1)
    want, _ = JE.encdec_forward(jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = M.forward(params, cfg, batch)
    assert got.shape == (B, S_DEC, cfg.padded_vocab)
    _close(got, want)
    assert {k: float(v) for k, v in aux.items()} == {"lb_loss": 0.0, "z_loss": 0.0,
                                                     "drop_frac": 0.0}


def test_prefill_cache_and_decode_steps_match_jax(pair):
    """``init_cache``'s length is the encoder's; ``encdec_prefill_cache``
    fills the cross K/V; each decode step's logits and all four cache
    fields against the reference's."""
    jcfg, jparams, cfg, params = pair
    batch = _inputs(cfg, seed=2)
    jcache = JM.init_cache(jcfg, B, S_ENC)
    cache = M.init_cache(cfg, B, S_ENC, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in jcache.items()}
    assert cache["self_k"].shape[3] == cfg.max_target_len
    assert not bool(cache["cross_k"].any())
    jcache = JE.encdec_prefill_cache(jparams, jcfg, jnp.asarray(batch["frames"]), jcache)
    cache = E.encdec_prefill_cache(params, cfg, batch["frames"], cache)
    for k in cache:
        _close(cache[k], jcache[k], msg=f"prefill {k}")
    for pos in range(8):
        tok = batch["tokens"][:, pos]
        jl, jcache = JM.decode_step(jparams, jcfg, jnp.asarray(tok), jcache, jnp.int32(pos))
        lg, cache = M.decode_step(params, cfg, torch.from_numpy(tok), cache, pos)
        _close(lg, jl, msg=f"pos {pos}")
        for k in cache:
            _close(cache[k], jcache[k], msg=f"pos {pos} {k}")


def test_decode_agrees_with_forward(pair):
    """After ``encdec_prefill_cache`` the cached decode of the tokens gives
    the forward's logits at every position."""
    _, _, cfg, params = pair
    batch = _inputs(cfg, seed=3, s_dec=16)
    full, _ = M.forward(params, cfg, batch)
    cache = E.encdec_prefill_cache(params, cfg, batch["frames"],
                                   M.init_cache(cfg, B, S_ENC, device="cpu"))
    for pos in range(16):
        lg, cache = M.decode_step(params, cfg, torch.from_numpy(batch["tokens"][:, pos]),
                                  cache, pos)
        torch.testing.assert_close(lg, full[:, pos], rtol=TOL, atol=TOL)


def test_plain_attention_hook_reaches_all_three_attentions(pair):
    """``_attention`` replaces the encoder's (causal=False, sq = sk), the
    decoder's (causal=True) and the cross-attention's (causal=False,
    sq < sk) calls, and the prefill cache's encoder."""
    _, _, cfg, params = pair
    from repro_torch.kernels.attention_plain import chunked_attention
    calls = []

    def spy(q, k, v, *, causal):
        calls.append((causal, q.shape[2], k.shape[2]))
        return chunked_attention(q, k, v, causal=causal)

    batch = _inputs(cfg, seed=4)
    got, _ = M.forward(params, cfg, batch, _attention=spy)
    torch.testing.assert_close(got, M.forward(params, cfg, batch)[0], rtol=0, atol=0)
    enc, dec = cfg.encoder_layers, cfg.n_layers
    assert calls == [(False, S_ENC, S_ENC)] * enc + [(True, S_DEC, S_DEC),
                                                      (False, S_DEC, S_ENC)] * dec
    calls.clear()
    E.encdec_prefill_cache(params, cfg, batch["frames"],
                           M.init_cache(cfg, B, S_ENC, device="cpu"), _attention=spy)
    assert calls == [(False, S_ENC, S_ENC)] * enc


def test_bf16_weights_convert_and_match_jax():
    """bfloat16 parameters and compute: every leaf converts as bfloat16,
    and the logits stay within 2 bf16 ulps of the largest |logit| (as
    ``test_torch_models.py`` holds the dense model)."""
    jcfg, jparams, cfg, params = _pair(param_dtype="bfloat16", compute_dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in params.parameters())
    batch = _inputs(cfg, seed=5)
    want, _ = JE.encdec_forward(jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    want = np.asarray(want.astype(jnp.float32))
    got, _ = M.forward(params, cfg, batch)
    assert got.dtype == torch.bfloat16
    top = float(np.abs(want).max())
    tol = 2 * 2.0 ** (np.floor(np.log2(top)) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_matches_the_converted_tree(dtype):
    _, jparams, cfg, converted = _pair(param_dtype=dtype)
    params = M.init_params(cfg, 0, device="cpu")
    assert isinstance(params, E.EncDec)
    shape = lambda m: {n: (tuple(p.shape), p.dtype) for n, p in m.named_parameters()}
    assert shape(params) == shape(converted)
    assert M.param_count(params) == sum(int(np.prod(x.shape))
                                        for x in jax.tree.leaves(jparams))
    # truncated at 2 x 0.02, in the parameter dtype
    top = float(torch.tensor(2 * 0.02).to(params.dec_pos.dtype))
    assert float(params.dec_pos.abs().max()) <= top + 1e-6


def test_exact_param_count_at_full_size():
    """whisper-tiny: exactly the reference's ``exact_param_count``,
    36,620,160 (``cfg.param_count``, the reference's copy, says 36,440,448),
    and ``chip_smoke.py``'s pin."""
    from repro.configs import get_config as jax_get_config
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    cfg = get_config(ARCH)
    meta = E.init_encdec(cfg, torch.Generator(), "meta")
    assert M.param_count(meta) == JM.exact_param_count(jax_get_config(ARCH)) == 36_620_160
    assert cfg.param_count == 36_440_448
    assert chip_smoke.LM_FAMILIES_FULL["audio"]["params"] == 36_620_160
    assert (len(meta.enc_blocks), len(meta.dec_blocks)) == (4, 4)


def test_serve_loop_gives_the_jax_tokens():
    """``launch/serve --arch whisper-tiny --knn``: no encoder runs (zero
    cross K/V), the prompt fed through the self-attention cache; the JAX
    package's tokens."""
    argv = ["--smoke", "--arch", ARCH, "--steps", "6", "--prompt-len", "8", "--knn"]
    want = np.asarray(jserve.main(argv))
    _, _, cfg, params = _pair()
    args = serve.parser().parse_args(argv + ["--device", "cpu"])
    store = serve._build_store(args, cfg, "cpu")
    got, _ = serve.serve_loop(args, cfg, params, store)
    np.testing.assert_array_equal(got, want)


def test_serve_main_refuses_positions_past_the_decoder():
    toks = serve.main(["--smoke", "--arch", ARCH, "--knn", "--device", "cpu",
                       "--prompt-len", "60", "--steps", "4"])     # 64 = max_target_len
    assert toks.shape == (4, 5)
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--arch", ARCH, "--knn", "--device", "cpu",
                    "--prompt-len", "60", "--steps", "5"])
