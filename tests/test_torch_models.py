"""The port's LM stack against the JAX package on the CPU.

Both packages run the same weights: the JAX init (``PRNGKey(0)``) goes to
numpy and into the port through ``models.convert.params_from_jax``.  The
JAX side uses its XLA attention (``ATTN_IMPL = "xla"``), the port its plain
attention (CPU tensors).  Tolerance 1e-4 on logits and decode caches: the
two frameworks sum the matrix products in different orders.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.all_archs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = 1e-4
DENSE_ARCHS = ["qwen2.5-3b", "starcoder2-3b", "codeqwen1.5-7b", "yi-34b",
               "internvl2-1b"]


def _pair(arch, **overrides):
    jcfg = dataclasses.replace(jax_smoke_config(arch), **overrides)
    cfg = dataclasses.replace(smoke_config(arch), **overrides)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _batch(cfg, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        batch["image_embeds"] = rng.normal(
            size=(b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_logits_match_jax(arch):
    jcfg, jparams, cfg, params = _pair(arch)
    batch = _batch(cfg)
    want, _ = JM.forward(jparams, jcfg, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    got, _ = M.forward(params, cfg, batch)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_decode_steps_and_caches_match_jax():
    jcfg, jparams, cfg, params = _pair("qwen2.5-3b")
    b, length = 3, 12
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (8, b)).astype(np.int32)
    jcache = JM.init_cache(jcfg, b, length)
    cache = M.init_cache(cfg, b, length, device="cpu")
    for pos in range(8):
        jl, jcache = JM.decode_step(jparams, jcfg, jax.numpy.asarray(toks[pos]),
                                    jcache, jax.numpy.int32(pos))
        lg, cache = M.decode_step(params, cfg, torch.from_numpy(toks[pos]), cache, pos)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
        for layer in range(cfg.n_layers):
            for i in range(2):          # k, v
                np.testing.assert_allclose(
                    cache[layer]["kv"][i].numpy(),
                    np.asarray(jcache[0]["kv"][i][layer]), rtol=TOL, atol=TOL)


def test_decode_agrees_with_forward():
    """The cached decode of a sequence gives the forward's logits."""
    _, _, cfg, params = _pair("qwen2.5-3b")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    full, _ = M.forward(params, cfg, {"tokens": toks})
    cache = M.init_cache(cfg, 2, 10, device="cpu")
    for pos in range(10):
        lg, cache = M.decode_step(params, cfg, torch.from_numpy(toks[:, pos]), cache, pos)
        torch.testing.assert_close(lg, full[:, pos], rtol=TOL, atol=TOL)


def test_padded_heads_stay_inert():
    # 4 heads padded to 6: the two padded heads' weights must not matter
    jcfg, jparams, cfg, params = _pair("qwen2.5-3b", head_pad=3)
    assert cfg.padded_heads == 6 and params.blocks[0].attn.wq.shape[1] == 6
    batch = _batch(cfg, s=16)
    want, _ = JM.forward(jparams, jcfg, {"tokens": jax.numpy.asarray(batch["tokens"])})
    got, _ = M.forward(params, cfg, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    for blk in params.blocks:
        blk.attn.wq[:, 4:].normal_()
        blk.attn.wo[4:].normal_()
        blk.attn.bq[4:].normal_()
    again, _ = M.forward(params, cfg, batch)
    assert torch.equal(again, got)
    cache = M.init_cache(cfg, 2, 4, device="cpu")
    lg, _ = M.decode_step(params, cfg, torch.from_numpy(batch["tokens"][:, 0]), cache, 0)
    torch.testing.assert_close(lg, got[:, 0], rtol=TOL, atol=TOL)


def test_init_params_shapes_and_count():
    cfg = smoke_config("qwen2.5-3b")
    params = M.init_params(cfg, 0, device="cpu")
    jparams = JM.init_params(jax_smoke_config("qwen2.5-3b"), jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jparams))
    assert M.param_count(params) == want
    # cfg.param_count leaves out the final norm's scale
    assert M.param_count(params) == cfg.param_count + cfg.d_model
    assert not any(p.requires_grad for p in params.parameters())
    again = M.init_params(cfg, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(), again.parameters()))
    w = params.blocks[0].attn.wq
    assert w.shape == (cfg.d_model, cfg.padded_heads, cfg.d_head)
    assert float(w.abs().max()) <= 2.0 * cfg.d_model ** -0.5 + 1e-6


def test_params_from_jax_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA card")
    cfg = smoke_config("qwen2.5-3b")
    jparams = JM.init_params(jax_smoke_config("qwen2.5-3b"), jax.random.PRNGKey(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(jax.tree.map(np.asarray, jparams), cfg)


def test_full_config_matches_reference_numbers():
    cfg = get_config("qwen2.5-3b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab_size, cfg.d_head) == (36, 2048, 16, 2, 11008, 151936, 128)
    assert 3.0e9 < cfg.param_count < 3.2e9


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-1.3b",
                                  "qwen2-moe-a2.7b", "whisper-tiny"])
def test_unported_families_raise(arch):
    cfg = smoke_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.init_params(cfg, 0, device="cpu")
