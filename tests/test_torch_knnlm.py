"""The port's kNN-LM serving path against the JAX package on the CPU.

Datastore: the tree ``KnnLmDatastore.build`` makes, bitwise against the
JAX store's (all 16 fields); retrieval ids and distances bitwise, kNN
log-probs within 1e-6 (the scatter-add of the weights may sum duplicate
tokens in another order); Delete-driven eviction, then ``validate``.
Serving: the port's loop on weights converted from the JAX init gives the
same tokens as ``repro.launch.serve.main``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.all_archs import smoke_config as jax_smoke_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import knnlm as J  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import smtree as T  # noqa: E402
from repro_torch.core.convert import tree_to_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import knnlm  # noqa: E402

FIELDS = ("dists", "ids", "page_hits", "dist_evals", "overflow")


def _stores(metric="l2", n=700, dim=24, seed=0, capacity=8):
    rng = np.random.default_rng(seed)
    keys = rng.standard_normal((n, dim)).astype(np.float32)
    vals = rng.integers(0, 97, n).astype(np.int32)
    jcfg = J.KnnLmConfig(k=5, metric=metric, capacity=capacity, max_frontier=64)
    js = J.KnnLmDatastore(jcfg, dim)
    js.build(keys, vals)
    ts = knnlm.KnnLmDatastore(knnlm.KnnLmConfig(**dataclasses.asdict(jcfg)),
                              dim, device="cpu")
    ts.build(keys, vals)
    return js, ts, rng


def _assert_same_tree(js, ts):
    got, meta = tree_to_numpy(ts.engine.tree)
    for f in T.ARRAY_FIELDS:
        want = np.asarray(getattr(js.engine.tree, f))
        np.testing.assert_array_equal(got[f], want, err_msg=f)
    for f in T.META_FIELDS:
        assert meta[f] == getattr(js.engine.tree, f), f


def _queries(rng, n, dim):
    return rng.standard_normal((n, dim)).astype(np.float32)


@pytest.mark.parametrize("metric", ["l2", "l1", "d_inf"])
def test_build_tree_bitwise(metric):
    js, ts, _ = _stores(metric)
    assert int(ts.engine.tree.height) >= 3
    _assert_same_tree(js, ts)


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_retrieval_bitwise_and_logprobs(metric):
    js, ts, rng = _stores(metric)
    h = _queries(rng, 9, 24)
    jres = js.engine.knn(jnp.asarray(h), k=5, max_frontier=64)
    tres = ts.retrieve(torch.from_numpy(h))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tres, f).numpy(),
                                      np.asarray(getattr(jres, f)), err_msg=f)
    want = np.asarray(js.knn_logits(jnp.asarray(h), 97))
    got = ts.knn_logits(torch.from_numpy(h), 97)
    assert got.shape == (9, 97) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_retrieve_private_scorer_goes_through_engine_knn():
    """``retrieve(_scorer=)`` takes the same entry as ``retrieve()``
    (``SMTreeEngine.knn``) and only swaps the frontier scorer."""
    from repro_torch.kernels.frontier import frontier_scores_torch
    _, ts, rng = _stores("l2")
    h = torch.from_numpy(_queries(rng, 7, 24))
    calls = []

    def scorer(*a, **kw):
        calls.append(1)
        return frontier_scores_torch(*a, **kw)

    want = ts.retrieve(h)
    got = ts.retrieve(h, _scorer=scorer)
    assert len(calls) >= int(ts.engine.tree.height)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f).numpy(), err_msg=f)


def test_mix_logits_matches_jax():
    rng = np.random.default_rng(4)
    lm = rng.normal(size=(3, 50)).astype(np.float32) * 3
    knn = np.log(np.maximum(rng.dirichlet(np.ones(50), 3), 1e-10)).astype(np.float32)
    want = np.asarray(J.mix_logits(jnp.asarray(lm), jnp.asarray(knn), 0.3))
    got = knnlm.mix_logits(torch.from_numpy(lm), torch.from_numpy(knn), 0.3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    probs = got.exp().sum(-1)
    torch.testing.assert_close(probs, torch.ones(3), rtol=1e-5, atol=1e-5)


def test_evict_before_then_validate_matches_jax():
    js, ts, rng = _stores("l2", n=500)
    assert ts.evict_before(200) == js.evict_before(200) == 200
    assert ts.engine.validate()
    assert ts.engine.n_objects == 300
    _assert_same_tree(js, ts)
    h = _queries(rng, 6, 24)
    jres = js.engine.knn(jnp.asarray(h), k=5, max_frontier=64)
    tres = ts.retrieve(torch.from_numpy(h))
    np.testing.assert_array_equal(tres.ids.numpy(), np.asarray(jres.ids))
    assert bool((tres.ids >= 200).all())
    assert not ts.evict(3)                   # already gone


def test_add_batch_and_evict_batch_match_jax():
    js, ts, rng = _stores("l2", n=300)
    new = _queries(rng, 40, 24)
    vals = rng.integers(0, 97, 40).astype(np.int32)
    np.testing.assert_array_equal(ts.add_batch(new, vals), js.add_batch(new, vals))
    ts.add(new[0] + 1.0, 5)
    js.add(new[0] + 1.0, 5)
    assert ts.evict_batch(np.arange(10, 60)) == js.evict_batch(np.arange(10, 60))
    _assert_same_tree(js, ts)
    np.testing.assert_array_equal(ts.values, js.values)
    assert ts.engine.validate()
    h = torch.from_numpy(new[:4])
    np.testing.assert_allclose(ts.knn_logits(h, 97).numpy(),
                               np.asarray(js.knn_logits(jnp.asarray(new[:4]), 97)),
                               rtol=0, atol=1e-6)


def test_unported_store_features_raise():
    _, ts, _ = _stores("l2", n=100)
    for call, part in ((ts.enable_stream, 1), (ts.enable_frontend, 2),
                       (ts.enable_replication, 2)):
        with pytest.raises(NotImplementedError, match=rf"ROADMAP Queue 1 item 13\.{part}\)"):
            call()
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item 13\.4\)"):
        knnlm.KnnLmDatastore(knnlm.KnnLmConfig(), 8, mesh=object(), device="cpu")


def _smoke_pair():
    jcfg = jax_smoke_config("qwen2.5-3b")
    cfg = smoke_config("qwen2.5-3b")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("knn", [True, False])
def test_serve_loop_gives_the_jax_tokens(knn):
    argv = ["--smoke", "--steps", "8", "--prompt-len", "12"] + (["--knn"] if knn else [])
    want = np.asarray(jserve.main(argv))
    _, _, cfg, params = _smoke_pair()
    args = serve.parser().parse_args(argv + ["--device", "cpu"])
    store = serve._build_store(cfg, args.lam, "cpu") if knn else None
    got, timing = serve.serve_loop(args, cfg, params, store)
    assert got.shape == (4, 9) and timing["ms_per_step"] > 0
    np.testing.assert_array_equal(got, want)


def test_serve_main_on_cpu_and_unported_flags():
    toks = serve.main(["--smoke", "--knn", "--device", "cpu", "--steps", "3",
                       "--prompt-len", "4"])
    assert toks.shape == (4, 4) and toks.dtype == np.int32
    for flag in (["--knn-mutate"], ["--frontend"], ["--replicas", "2"],
                 ["--knn-shards", "2"], ["--mesh", "host"], ["--obs"],
                 ["--slo-ms", "5"], ["--cohort-width", "8"],
                 ["--rebalance-mode", "incremental"], ["--obs-out", "obs.json"]):
        with pytest.raises(SystemExit):
            serve.main(["--smoke", "--knn", "--device", "cpu"] + flag)


def test_decode_with_knnlm_matches_jax():
    jcfg, jparams, cfg, params = _smoke_pair()
    js, ts, _ = _stores("l2", n=400, dim=cfg.d_model, seed=5)
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 6)).astype(np.int32)
    want = J.decode_with_knnlm(jparams, jcfg, js, jnp.asarray(prompt), 5, lam=0.4)
    got = knnlm.decode_with_knnlm(params, cfg, ts, torch.from_numpy(prompt), 5, lam=0.4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hidden_state_tap_matches_jax():
    """The kNN-LM key tap (examples/knnlm_serve.py's ``hidden_states``)."""
    from repro.models.layers import apply_norm
    from repro.models.transformer import _block_apply, embed_inputs
    jcfg, jparams, cfg, params = _smoke_pair()
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    x, pos = embed_inputs(jparams, jcfg, {"tokens": jnp.asarray(toks)})

    def period_fn(x, pp):
        for j, kind in enumerate(jcfg.block_pattern):
            x, _ = _block_apply(kind, pp[j], jcfg, x, pos, None)
        return x, None
    x, _ = jax.lax.scan(period_fn, x, jparams["blocks"])
    want = apply_norm(jparams["final_norm"], x, jcfg.norm, jcfg.norm_eps)
    got = transformer.hidden_states(params, cfg, {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
