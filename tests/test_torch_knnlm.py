"""The port's kNN-LM serving path against the JAX package on the CPU.

Datastore: the tree ``KnnLmDatastore.build`` makes, bitwise against the
JAX store's (all 16 fields); retrieval ids and distances bitwise, kNN
log-probs within 1e-6 (the scatter-add of the weights may sum duplicate
tokens in another order); Delete-driven eviction, then ``validate``.
Serving: the port's loop on weights converted from the JAX init gives the
same tokens as ``repro.launch.serve.main``.
"""
import dataclasses
import json

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
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

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
    """The front-end and replication are ported (13.2): out of order they
    raise the reference's ValueErrors.  The mesh store (13.4) is not."""
    _, ts, _ = _stores("l2", n=100)
    with pytest.raises(ValueError, match=r"enable_stream\(\) before enable_frontend"):
        ts.enable_frontend()
    with pytest.raises(ValueError, match=r"enable_stream\(wal_dir=\.\.\.\) before"):
        ts.enable_replication("unused")
    ts.enable_stream()
    with pytest.raises(ValueError, match=r"enable_stream\(wal_dir=\.\.\.\) before"):
        ts.enable_replication("unused")
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item 13\.4\)"):
        knnlm.KnnLmDatastore(knnlm.KnnLmConfig(), 8, mesh=object(), device="cpu")


@pytest.mark.parametrize("shards", [0, 3])
def test_stream_store_matches_jax(shards, tmp_path):
    """``enable_stream`` (one tree, or a forest of ``shards``): batched
    add/evict with a WAL give the JAX store's trees, the same removal
    counts and the same kNN log-probs; an epoch pinned before a batch keeps
    its digest."""
    from repro.stream import tree_digest as jdigest
    from repro_torch.stream import tree_digest
    js, ts, rng = _stores("l2", n=300)
    kw = dict(shards=shards, max_batch=64)
    jstream = js.enable_stream(str(tmp_path / "jwal"), **kw)
    tstream = ts.enable_stream(str(tmp_path / "twal"), **kw)
    trees = (lambda st: st.trees) if shards else (lambda st: st.tree)
    new = _queries(rng, 40, 24)
    vals = rng.integers(0, 97, 40).astype(np.int32)
    with tstream.epochs.reading() as pinned:
        before = tree_digest(pinned)
        np.testing.assert_array_equal(ts.add_batch(new, vals), js.add_batch(new, vals))
        assert ts.evict_batch(np.arange(10, 60)) == js.evict_batch(np.arange(10, 60)) == 50
        assert tree_digest(pinned) == before
    assert tree_digest(trees(tstream)) == jdigest(trees(jstream))
    if not shards:
        _assert_same_tree(js, ts)             # engine.tree: the published epoch
    h = new[:4] + 0.01
    np.testing.assert_allclose(ts.knn_logits(torch.from_numpy(h), 97).numpy(),
                               np.asarray(js.knn_logits(jnp.asarray(h), 97)),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="add_batch/evict_batch"):
        ts.evict(70)


def _smoke_pair(arch="qwen2.5-3b"):
    jcfg = jax_smoke_config(arch)
    cfg = smoke_config(arch)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("knn", [True, False])
def test_serve_loop_gives_the_jax_tokens(knn):
    argv = ["--smoke", "--steps", "8", "--prompt-len", "12"] + (["--knn"] if knn else [])
    want = np.asarray(jserve.main(argv))
    _, _, cfg, params = _smoke_pair()
    args = serve.parser().parse_args(argv + ["--device", "cpu"])
    store = serve._build_store(args, cfg, "cpu") if knn else None
    got, timing = serve.serve_loop(args, cfg, params, store)
    assert got.shape == (4, 9) and timing["ms_per_step"] > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-v0.1-52b"])
def test_serve_loop_gives_the_jax_tokens_for_moe_and_mamba(arch):
    """``--arch qwen2-moe-a2.7b --knn`` (the MoE block, keys of width
    d_model) and jamba's period (Mamba, MoE and attention blocks; the
    prompt fed through the Mamba decode cache): the JAX package's tokens."""
    argv = ["--smoke", "--arch", arch, "--steps", "6", "--prompt-len", "8", "--knn"]
    want = np.asarray(jserve.main(argv))
    _, _, cfg, params = _smoke_pair(arch)
    args = serve.parser().parse_args(argv + ["--device", "cpu"])
    store = serve._build_store(args, cfg, "cpu")
    assert store.engine.tree.vecs.shape[-1] == cfg.d_model
    got, _ = serve.serve_loop(args, cfg, params, store)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shards", [0, 4])
def test_serve_loop_with_knn_mutate_gives_the_jax_tokens(shards):
    """``--knn-mutate``: each decode step adds its entries and evicts as
    many of the oldest through the stream plane (a forest of 4 shards with
    ``--knn-shards 4``); the tokens are those of the JAX package's
    ``launch/serve``."""
    argv = ["--smoke", "--steps", "6", "--prompt-len", "8", "--knn", "--knn-mutate"]
    argv += ["--knn-shards", str(shards)] if shards else []
    want = np.asarray(jserve.main(argv))
    _, _, cfg, params = _smoke_pair()
    args = serve.parser().parse_args(argv + ["--device", "cpu"])
    store = serve._build_store(args, cfg, "cpu")
    got, timing = serve.serve_loop(args, cfg, params, store)
    np.testing.assert_array_equal(got, want)
    assert timing["mutations"] == 2 * args.batch * args.steps
    assert len(store.values) == 2048 + args.batch * args.steps


def test_serve_main_obs_snapshot(tmp_path, capsys):
    from repro_torch import obs
    out = tmp_path / "obs.json"
    try:
        serve.main(["--smoke", "--knn", "--knn-mutate", "--device", "cpu", "--steps", "3",
                    "--prompt-len", "4", "--obs", "--obs-out", str(out)])
    finally:
        obs.disable()
        obs.reset()
    line = next(ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[obs] "))
    snap = json.loads(line[len("[obs] "):])
    assert snap == json.loads(out.read_text()) and snap["enabled"]
    m = snap["metrics"]
    assert m["stream.batches_total"] == 6 and m["stream.rows_total"] == 24
    assert m["epoch.publishes_total"] == 6


def test_serve_main_on_cpu_and_unported_flags():
    toks = serve.main(["--smoke", "--knn", "--device", "cpu", "--steps", "3",
                       "--prompt-len", "4"])
    assert toks.shape == (4, 4) and toks.dtype == np.int32
    # the reference's flag rules: --replicas needs --frontend, --knn-shards
    # needs a stream and does not compose with --replicas; the mesh is not
    # ported (the front-end's own flags parse: test_torch_serve_e2e.py)
    for flag in (["--replicas", "2"], ["--knn-shards", "2"],
                 ["--knn-shards", "2", "--frontend", "--replicas", "1"],
                 ["--mesh", "host"]):
        with pytest.raises(SystemExit):
            serve.main(["--smoke", "--knn", "--device", "cpu"] + flag)
    args = serve.parser().parse_args(["--frontend", "--slo-ms", "5", "--cohort-width", "8"])
    assert args.frontend and args.slo_ms == 5.0 and args.cohort_width == 8


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
