"""The port's LM stack against the JAX package on the CPU.

Both packages run the same weights: the JAX init (``PRNGKey(0)``) goes to
numpy and into the port through ``models.convert.params_from_jax``.  The
JAX side uses its XLA attention (``ATTN_IMPL = "xla"``), the port its plain
attention (CPU tensors).  Tolerance 1e-4 on logits, aux values and decode
caches: the two frameworks sum the matrix products in different orders.
In bfloat16, logits within 2 bf16 ulps of the largest |logit|.  The MoE,
Mamba and xLSTM families (qwen2-moe, grok, jamba, xlstm) map the port's
layer ``p * len(pattern) + j`` to the reference's ``blocks[j]`` at period
``p``; the encoder-decoder (whisper) takes frames beside its tokens, and
its decode runs after ``encdec_prefill_cache`` on both sides.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.all_archs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

TOL = 1e-4
DENSE_ARCHS = ["qwen2.5-3b", "starcoder2-3b", "codeqwen1.5-7b", "yi-34b",
               "internvl2-1b"]
FAMILY_ARCHS = ["qwen2-moe-a2.7b", "grok-1-314b", "jamba-v0.1-52b", "xlstm-1.3b",
                "whisper-tiny"]


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
    if cfg.is_encdec:
        batch["frames"] = rng.normal(size=(b, s + 5, cfg.d_model)).astype(np.float32)
    return batch


def _jnp(batch):
    return {k: jax.numpy.asarray(v) for k, v in batch.items()}


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
    assert cfg.padded_heads == 6 and params.blocks[0].mixer.wq.shape[1] == 6
    batch = _batch(cfg, s=16)
    want, _ = JM.forward(jparams, jcfg, {"tokens": jax.numpy.asarray(batch["tokens"])})
    got, _ = M.forward(params, cfg, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    for blk in params.blocks:
        blk.mixer.wq[:, 4:].normal_()
        blk.mixer.wo[4:].normal_()
        blk.mixer.bq[4:].normal_()
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
    w = params.blocks[0].mixer.wq
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


def _assert_caches(cache, jcache, cfg):
    """The port's per-layer cache against the reference's stacked one (an
    enc-dec cache: the same four stacked fields on both sides)."""
    if cfg.is_encdec:
        assert set(cache) == set(jcache)
        for key in cache:
            np.testing.assert_allclose(cache[key].float().numpy(), np.asarray(jcache[key]),
                                       rtol=TOL, atol=TOL, err_msg=key)
        return
    P = len(cfg.block_pattern)
    for layer in range(cfg.n_layers):
        j, per = layer % P, layer // P
        for key, got in cache[layer].items():
            want = jcache[j][key]
            if key == "kv":
                got, want = got, tuple(want)
            else:
                got, want = (got,), (want,)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.float().numpy(), np.asarray(w[per]),
                                           rtol=TOL, atol=TOL, err_msg=f"{layer} {key}")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_forward_logits_and_aux_match_jax(arch):
    jcfg, jparams, cfg, params = _pair(arch)
    batch = _batch(cfg)
    want, waux = JM.forward(jparams, jcfg, _jnp(batch))
    got, aux = M.forward(params, cfg, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert set(aux) == set(waux) == {"lb_loss", "z_loss", "drop_frac"}
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(waux[k]), rtol=TOL, atol=TOL,
                                   err_msg=k)
    if cfg.n_experts:
        assert float(aux["drop_frac"]) > 0 and float(aux["lb_loss"]) > 0
    else:
        assert all(float(v) == 0.0 for v in aux.values())


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_decode_steps_and_caches_match_jax(arch):
    jcfg, jparams, cfg, params = _pair(arch)
    b, length = 3, 12
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (8, b)).astype(np.int32)
    jcache = JM.init_cache(jcfg, b, length)
    cache = M.init_cache(cfg, b, length, device="cpu")
    if cfg.is_encdec:
        # length is the encoder's: fill the cross K/V from frames that long
        from repro.models.encdec import encdec_prefill_cache as jprefill
        from repro_torch.models.encdec import encdec_prefill_cache
        frames = _batch(cfg, b=b, s=length - 5, seed=3)["frames"]
        jcache = jprefill(jparams, jcfg, jax.numpy.asarray(frames), jcache)
        cache = encdec_prefill_cache(params, cfg, frames, cache)
        assert set(cache) == {"self_k", "self_v", "cross_k", "cross_v"}
    else:
        kinds = {tuple(c) for c in cache}
        want = {"attn": ("kv",), "attn_moe": ("kv",), "mamba": ("conv", "h"),
                "mamba_moe": ("conv", "h"), "mlstm": ("conv", "C", "n", "m"),
                "slstm": ("c", "n", "h", "m")}
        assert kinds == {want[k] for k in cfg.block_pattern}
    for pos in range(8):
        jl, jcache = JM.decode_step(jparams, jcfg, jax.numpy.asarray(toks[pos]),
                                    jcache, jax.numpy.int32(pos))
        lg, cache = M.decode_step(params, cfg, torch.from_numpy(toks[pos]), cache, pos)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
        _assert_caches(cache, jcache, cfg)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_decode_agrees_with_dropless_forward(arch):
    """Decode is dropless (capacity = batch); a forward with capacity
    factor E / k is too, and gives the same logits and routing.  Without
    MoE layers the forward as it is (xLSTM: chunk-parallel against
    recurrent; whisper: after the cross K/V of the forward's frames)."""
    _, _, cfg, params = _pair(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    batch = _batch(cfg, s=10, seed=2)
    toks = batch["tokens"]
    routing = []
    full, aux = M.forward(params, cfg, batch, _routing=routing)
    assert float(aux["drop_frac"]) == 0.0
    assert bool(routing) == bool(cfg.n_experts)
    if cfg.is_encdec:
        from repro_torch.models.encdec import encdec_prefill_cache
        frames = batch["frames"]
        cache = encdec_prefill_cache(params, cfg, frames, M.init_cache(
            cfg, 2, frames.shape[1], device="cpu"))
    else:
        cache = M.init_cache(cfg, 2, 10, device="cpu")
    for pos in range(10):
        step = []
        lg, cache = M.decode_step(params, cfg, torch.from_numpy(toks[:, pos]), cache, pos,
                                  _routing=step)
        torch.testing.assert_close(lg, full[:, pos], rtol=TOL, atol=TOL)
        for fwd, dec in zip(routing, step, strict=True):
            assert torch.equal(dec["gate_i"], fwd["gate_i"].reshape(2, 10, -1)[:, pos])
            assert bool(dec["keep"].all())


def test_learned_positions_match_jax():
    """A decoder with ``pos_embedding="learned"``: the reference adds
    ``pos_embed`` in the forward and at decode; the port carries the leaf
    and adds it too (before, it dropped it: logits off by up to 0.90)."""
    jcfg, jparams, cfg, params = _pair("qwen2.5-3b", pos_embedding="learned")
    assert params.pos_embed.shape == (cfg.max_target_len, cfg.d_model)
    batch = _batch(cfg, s=12)
    want, _ = JM.forward(jparams, jcfg, {"tokens": jax.numpy.asarray(batch["tokens"])})
    got, _ = M.forward(params, cfg, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    jcache, cache = JM.init_cache(jcfg, 2, 6), M.init_cache(cfg, 2, 6, device="cpu")
    for pos in range(4):
        tok = batch["tokens"][:, pos]
        jl, jcache = JM.decode_step(jparams, jcfg, jax.numpy.asarray(tok), jcache,
                                    jax.numpy.int32(pos))
        lg, cache = M.decode_step(params, cfg, torch.from_numpy(tok), cache, pos)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    init = M.init_params(cfg, 0, device="cpu")
    assert init.pos_embed.shape == params.pos_embed.shape
    assert float(init.pos_embed.abs().max()) <= 2 * 0.02 + 1e-6


def test_bf16_weights_convert_and_match_jax():
    """``params_from_jax`` reads bfloat16 leaves (it raised TypeError on
    them); param and compute bf16 logits within 2 bf16 ulps of the largest
    |logit| (one ulp is 2^(e - 7) for |logit| in [2^e, 2^(e + 1)))."""
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg, jparams, cfg, params = _pair("qwen2.5-3b", **bf16)
    assert all(p.dtype == torch.bfloat16 for p in params.parameters())
    batch = _batch(cfg)
    want, _ = JM.forward(jparams, jcfg, {"tokens": jax.numpy.asarray(batch["tokens"])})
    want = np.asarray(want.astype(jax.numpy.float32))
    got, _ = M.forward(params, cfg, batch)
    assert got.dtype == torch.bfloat16
    top = float(np.abs(want).max())
    tol = 2 * 2.0 ** (np.floor(np.log2(top)) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    # the MoE router and Mamba's A_log and D stay float32, as the
    # reference makes them
    _, _, cfg, params = _pair("jamba-v0.1-52b", **bf16)
    f32 = {n for n, p in params.named_parameters() if p.dtype == torch.float32}
    assert f32 and all(n.rsplit(".", 1)[1] in ("router", "A_log", "D") for n in f32)
    assert {n.rsplit(".", 1)[1] for n in f32} == {"router", "A_log", "D"}


def test_bf16_gqa_model_matches_jax():
    """yi-34b, which ``chip_smoke.py`` runs in bf16 (param and compute
    dtype), at smoke size with its GQA group of 7 (14 query heads over 2
    KV heads): logits within 2 bf16 ulps of the largest |logit| of the JAX
    package's."""
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16", n_heads=14, n_kv_heads=2)
    jcfg, jparams, cfg, params = _pair("yi-34b", **bf16)
    batch = _batch(cfg)
    want, _ = JM.forward(jparams, jcfg, _jnp(batch))
    want = np.asarray(want.astype(jax.numpy.float32))
    got, _ = M.forward(params, cfg, batch)
    assert got.dtype == torch.bfloat16
    top = float(np.abs(want).max())
    tol = 2 * 2.0 ** (np.floor(np.log2(top)) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_bf16_moe_layer_matches_jax():
    """grok-1-314b's MoE FFN in bf16, top-2 of 8 at capacity factor 1.25:
    each layer's ``moe_apply`` against the reference's on the same bf16
    input and weights, y within 2 bf16 ulps of the largest |y| and the aux
    values (the load-balancing and z losses, the dropped share) equal.  A
    whole bf16 model is not held here: its router input carries the two
    frameworks' bf16 roundings, and a near tie routes a token apart."""
    from repro.models import moe as JMoE
    from repro_torch.models import moe as moe_mod
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg, jparams, cfg, params = _pair("grok-1-314b", **bf16)
    assert (cfg.n_experts, cfg.experts_per_token) == (8, 2)
    rng = np.random.default_rng(5)
    # one direction shared by every token skews the routing, so that some
    # experts overflow their capacity and drop
    x = (rng.normal(size=(2, 24, cfg.d_model))
         + 3 * rng.normal(size=(1, 1, cfg.d_model))).astype(np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jx = jax.numpy.asarray(tx.float().numpy()).astype(jax.numpy.bfloat16)
    moe_apply = jax.jit(JMoE.moe_apply, static_argnums=1)
    for layer in range(cfg.n_layers):
        jp = jax.tree.map(lambda a: a[layer], jparams["blocks"][0]["moe"])
        want, jaux = moe_apply(jp, jcfg, jx)
        want = np.asarray(want.astype(jax.numpy.float32))
        got, aux = moe_mod.moe_apply(params.blocks[layer].ffn, cfg, tx)
        assert got.dtype == torch.bfloat16
        top = float(np.abs(want).max())
        tol = 2 * 2.0 ** (np.floor(np.log2(top)) - 7)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
        assert 0 < float(aux["drop_frac"]) == float(jaux["drop_frac"])
        for k in ("lb_loss", "z_loss"):
            assert float(aux[k]) == pytest.approx(float(jaux[k]), rel=1e-5), k


def test_vlm_prefill_step_matches_jax():
    """internvl2-1b's prefill through ``make_prefill_step``: the vision
    stub's image embeddings ahead of the tokens (``model_batch``'s), the
    logits [b, n_img + s, V] within 1e-4 of the JAX package's prefill step
    on a (1, 1) mesh."""
    from repro.configs.base import ShapeSpec
    from repro.serve.serve_step import make_prefill_step as jax_prefill_step
    from repro_torch.data.pipeline import DataConfig, model_batch
    from repro_torch.serve.serve_step import make_prefill_step
    jcfg, jparams, cfg, params = _pair("internvl2-1b")
    n_img, s = cfg.n_image_tokens, 24
    batch = {k: v for k, v in model_batch(cfg, DataConfig(
        vocab_size=cfg.vocab_size, seq_len=n_img + s, global_batch=2), 0).items()
        if k != "labels"}
    assert batch["tokens"].shape == (2, s) and batch["image_embeds"].shape == (2, n_img, 64)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    fn, _ = jax_prefill_step(jcfg, mesh, ShapeSpec("prefill", n_img + s, 2, "prefill"))
    want = np.asarray(fn(jparams, _jnp(batch)))
    got = make_prefill_step(cfg)(params, batch)
    assert got.shape == (2, n_img + s, cfg.padded_vocab) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_family_init_matches_the_converted_tree(arch, dtype):
    """The port's own init makes the parameters that the JAX init converts
    to: the same names, shapes and dtypes, the same count."""
    _, jparams, cfg, converted = _pair(arch, param_dtype=dtype)
    params = M.init_params(cfg, 0, device="cpu")
    shape = lambda m: {n: (tuple(p.shape), p.dtype) for n, p in m.named_parameters()}
    assert shape(params) == shape(converted)
    assert M.param_count(params) == sum(int(np.prod(x.shape))
                                        for x in jax.tree.leaves(jparams))


def test_full_family_param_counts():
    """At full width, counted on the meta device: the port's parameters
    equal the reference's ``exact_param_count``, and ``chip_smoke.py``'s
    pinned counts (qwen2-moe-a2.7b at all 24 layers, jamba-v0.1-52b at one
    8-layer period) are those numbers.  jamba's ``cfg.param_count`` leaves
    out ``x_proj``'s dt columns and ``dt_proj``."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.models import transformer
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    fam = chip_smoke.LM_FAMILIES_FULL
    for arch, overrides, pinned in (
            ("qwen2-moe-a2.7b", {}, fam["moe"]["params"]),
            ("jamba-v0.1-52b", {"n_layers": 8}, fam["hybrid"]["params"]),
            ("grok-1-314b", {}, None)):
        jcfg = dataclasses.replace(jax_get_config(arch), **overrides)
        cfg = dataclasses.replace(get_config(arch), **overrides)
        want = JM.exact_param_count(jcfg)
        meta = transformer.init_lm(cfg, torch.Generator(), "meta")
        assert M.param_count(meta) == want, arch
        assert pinned in (None, want), arch
    assert fam["moe"]["params"] == 14_315_735_040
    assert fam["hybrid"]["params"] == 13_295_235_072


@pytest.mark.parametrize("arch,exact,cfg_count", [
    ("xlstm-1.3b", 3_609_147_728, 3_639_533_568),
    ("whisper-tiny", 36_620_160, 36_440_448)])
def test_exact_param_counts_of_the_recurrent_and_encdec_families(arch, exact, cfg_count):
    """At full size on the meta device the port's parameters equal the
    reference's ``exact_param_count``; ``cfg.param_count`` (the reference's
    copy, left as it is) differs, and ``chip_smoke.py`` pins the exact
    count of what its phase runs (xlstm-1.3b: one 8-layer period of it)."""
    from repro.configs import get_config as jax_get_config
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.models import encdec, transformer
    cfg = get_config(arch)
    meta = (encdec.init_encdec if cfg.is_encdec else transformer.init_lm)(
        cfg, torch.Generator(), "meta")
    assert M.param_count(meta) == JM.exact_param_count(jax_get_config(arch)) == exact
    assert cfg.param_count == cfg_count
    fam = chip_smoke.LM_FAMILIES_FULL["audio" if cfg.is_encdec else "xlstm"]
    if not fam["overrides"]:
        assert fam["params"] == exact
    assert fam["params"] == JM.exact_param_count(
        dataclasses.replace(jax_get_config(arch), **fam["overrides"]))


@pytest.mark.parametrize("arch", FAMILY_ARCHS + ["qwen2.5-3b"])
def test_block_spans_count_each_kind_under_the_profiler(arch):
    """Under torch.profiler each block opens one ``block.<kind>`` range
    around its mixer and one around its FFN, in a forward and in a decode
    step (an xLSTM block has no FFN; whisper's encoder blocks open
    ``enc_attn`` and run in the forward only, its decoder blocks ``attn``,
    ``xattn`` and ``mlp``); the logits are those of a run without the
    profiler."""
    _, _, cfg, params = _pair(arch)
    batch = _batch(cfg, b=2, s=8)
    toks = batch["tokens"]
    plain, _ = M.forward(params, cfg, batch)
    pattern = [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.n_layers)]
    want = {"attn": sum(k.startswith("attn") for k in pattern),
            "mamba": sum(k.startswith("mamba") for k in pattern),
            "mlstm": sum(k == "mlstm" for k in pattern),
            "slstm": sum(k == "slstm" for k in pattern),
            "moe": sum(k.endswith("_moe") for k in pattern),
            "mlp": sum(not k.endswith("_moe") for k in pattern) if cfg.d_ff else 0}
    want = {k: v for k, v in want.items() if v}
    wants = {"forward": want, "decode": want}
    cache = M.init_cache(cfg, 2, 8, device="cpu")
    if cfg.is_encdec:
        E, L = cfg.encoder_layers, cfg.n_layers
        wants = {"forward": {"enc_attn": E, "attn": L, "xattn": L, "mlp": E + L},
                 "decode": {"attn": L, "xattn": L, "mlp": L}}
    acts = [torch.profiler.ProfilerActivity.CPU]
    for run in ("forward", "decode"):
        with torch.profiler.profile(activities=acts) as prof:
            if run == "forward":
                got, _ = M.forward(params, cfg, batch)
            else:
                M.decode_step(params, cfg, torch.from_numpy(toks[:, 0]), cache, 0)
        spans = {ev.key.removeprefix("block."): ev.count for ev in prof.key_averages()
                 if ev.key.startswith("block.")}
        assert spans == wants[run], run
    assert torch.equal(got, plain)
