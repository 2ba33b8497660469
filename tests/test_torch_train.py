"""The port's training path against the JAX package on the CPU.

Both packages start from the same weights: the JAX init goes to numpy and
into the port through ``models.convert.params_from_jax``; batches come
from numpy seeds (``test_models_smoke.make_batch``: whisper's ``{frames,
tokens, labels}``, internvl2's ``image_embeds``).  The JAX side runs its
XLA attention; the port's attention is the flash ``autograd.Function``
(the plain forward on CPU tensors, the reference's recompute backward).

Tolerances, each stated where it is used: the loss within 1e-5 relative
(observed ~1e-7); every gradient leaf within 1e-4 of its largest |g|
(observed at most 2e-5, xLSTM's sLSTM loop); the moments after a step
likewise; a parameter after the step within 1e-6 where the clipped
gradient is above 1e-6 (there Adam's update is +-1 within 1e-2 of eps's
share in both packages) and within one step's reach, 2 lr, where it is
not (there the update g / (|g| + eps) turns on digits of g that the two
frameworks sum in different orders).
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import list_archs  # noqa: E402
from repro.configs.all_archs import smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JT  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels.attention_plain import chunked_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import (params_from_jax, params_to_tree,  # noqa: E402
                                        path_str, reference_layout, to_reference_tree)
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import train_step as TT  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_models_smoke import make_batch  # noqa: E402

ARCHS = list_archs()
MESH = jax.make_mesh((1, 1), ("data", "model"))
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
LEAF_TOL = 1e-4


def _is_t(x):
    return isinstance(x, torch.Tensor)


def _np(t):
    return t.detach().float().numpy()


def _pair(arch, seed=1):
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    params = M.trainable(params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    return jcfg, jparams, cfg, params


def _leaves_by_path(tree, is_leaf=None):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _close_to_leaf_max(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


# ---- loss, schedule, optimizer ---------------------------------------------
def test_loss_fn_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 37)) * 6).astype(np.float32)
    labels = rng.integers(0, 37, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.7).astype(np.float32)
    want = float(JM.loss_fn(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)))
    got = M.loss_fn(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * abs(want)          # stated: 1e-6 relative
    # its gradient against the reference's, within 1e-6 of the largest
    gj = jax.grad(lambda x: JM.loss_fn(x, jnp.asarray(labels), jnp.asarray(mask)))(
        jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    M.loss_fn(lt, torch.from_numpy(labels), torch.from_numpy(mask)).backward()
    _close_to_leaf_max(lt.grad.numpy(), np.asarray(gj), 1e-6, "loss gradient")


def test_lr_at_matches_jax_over_warmup_and_decay():
    cfg = dict(lr=3e-3, warmup_steps=5, total_steps=40, min_lr_frac=0.1)
    for step in range(0, 46):
        want = float(JO.lr_at(JO.AdamWConfig(**cfg), jnp.int32(step)))
        got = float(TO.lr_at(TO.AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32)))
        # stated: 1e-6 relative (a few ulps: the two cos implementations)
        assert abs(got - want) <= 1e-6 * abs(want), (step, got, want)


def _random_tree(rng):
    return {"blocks": [{"attn": {"wq": rng.normal(size=(3, 8, 4)), "bq": rng.normal(size=(3, 4))},
                        "norm1": {"scale": rng.normal(size=(3, 8))}}],
            "embed": rng.normal(size=(16, 8)), "mamba": {"A_log": rng.normal(size=(4, 2)),
                                                        "conv_b": rng.normal(size=(4,))}}


def test_adamw_update_matches_jax_on_random_trees():
    """Two updates from a mid-run state (step 7, nonzero moments), with the
    clip on (gradients of norm ~20) and off."""
    rng = np.random.default_rng(3)
    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
    params = f32(_random_tree(rng))
    mu = f32(jax.tree.map(lambda a: a * 0.01, _random_tree(rng)))
    nu = f32(jax.tree.map(lambda a: np.abs(a) * 1e-3, _random_tree(rng)))
    jcfg = JO.AdamWConfig(lr=2e-3, warmup_steps=4, total_steps=30)
    tcfg = TO.AdamWConfig(lr=2e-3, warmup_steps=4, total_steps=30)
    jstate = JO.AdamWState(jnp.int32(7), mu, nu)
    flat = lambda tree: {jax.tree_util.keystr(k): torch.tensor(np.array(v))
                         for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    paths = {jax.tree_util.keystr(k): "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                                               for p in k)
             for k, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    decay = {k: TO._decay_mask(p) for k, p in paths.items()}
    assert decay["['mamba']['conv_b']"] and not decay["['mamba']['A_log']"]
    assert not decay["['blocks'][0]['attn']['bq']"] and decay["['embed']"]
    tparams, tstate = flat(params), TO.AdamWState(torch.tensor(7, dtype=torch.int32),
                                                  flat(mu), flat(nu))
    jparams = params
    for g_scale in (5.0, 0.01):
        grads = f32(jax.tree.map(lambda a: a * g_scale, _random_tree(rng)))
        jparams, jstate, jm = JO.adamw_update(jcfg, jparams, grads, jstate)
        _, tstate, tm = TO.adamw_update(tcfg, tparams, flat(grads), tstate, decay)
        # stated: grad_norm and lr within 1e-6 relative, params and moments
        # within 1e-6 of each leaf's largest value (gradients far above eps)
        for k in ("grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * abs(float(jm[k]))
        assert int(tstate.step) == int(jstate.step)
        for jt, tt in ((jparams, tparams), (jstate.mu, tstate.mu), (jstate.nu, tstate.nu)):
            for k, v in _leaves_by_path(jt).items():
                _close_to_leaf_max(tt[k].numpy(), np.asarray(v), 1e-6, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_set_matches_jax(arch):
    """Weight decay applies to exactly the reference's leaves."""
    jcfg, jparams, cfg, params = _pair(arch)
    want = {}
    for k, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        s = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in k)
        want[s] = JO._decay_mask(k)
    layout = reference_layout(params, cfg)
    got = {path_str(path): TO._decay_mask(path_str(path)) for path, _ in layout.values()}
    assert got == want
    assert any(want.values()) and not all(want.values())


# ---- the flash Function's gradients ----------------------------------------
@pytest.mark.parametrize("b,h,hk,sq,sk,d,causal", [
    (2, 4, 2, 40, 40, 16, True),        # GQA, causal
    (1, 4, 1, 24, 56, 8, False)])       # sq < sk, not causal
def test_flash_function_grads_match_jax_custom_vjp(b, h, hk, sq, sk, d, causal):
    """The port's Function against the reference's ``ops.attention(impl=
    "interpret")``: its Pallas forward in interpret mode and its custom VJP
    (the chunked recompute); outputs and q/k/v gradients within 1e-5."""
    rng = np.random.default_rng(b * 100 + sq + sk)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((b, h, sq, d), (b, hk, sk, d), (b, hk, sk, d)))
    g = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda q_, k_, v_: jops.attention(q_, k_, v_, causal=causal,
                                                          impl="interpret"),
                         *(jnp.asarray(a) for a in (q, k, v)))
    grads_j = vjp(jnp.asarray(g))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention_fwd(qt, kt, vt, causal=causal)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(out), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the Function's CPU forward is the plain version's, bitwise
    assert torch.equal(out.detach(), chunked_attention(qt.detach(), kt.detach(), vt.detach(),
                                                       causal=causal))


def test_flash_function_backward_is_the_plain_versions_vjp():
    """Bitwise on the CPU: the recompute backward is autograd through
    ``chunked_attention`` itself; a gradient for k alone works too."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 30, 8)).astype(np.float32))
               for _ in range(3))
    g = torch.from_numpy(rng.normal(size=(1, 2, 30, 8)).astype(np.float32))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    flash_attention_fwd(*a, causal=True).backward(g)
    b_ = [t.clone().requires_grad_() for t in (q, k, v)]
    chunked_attention(*b_, causal=True).backward(g)
    for x, y in zip(a, b_):
        assert torch.equal(x.grad, y.grad)
    kk = k.clone().requires_grad_()
    (dk,) = torch.autograd.grad(flash_attention_fwd(q, kk, v), kk, g)
    assert torch.equal(dk, b_[1].grad)


# ---- the converter's inverse, trainable parameters, remat ------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_tree_inverts_params_from_jax(arch):
    jcfg, jparams, cfg, params = _pair(arch, seed=0)
    want = _leaves_by_path(jax.tree.map(np.asarray, jparams))
    got = _leaves_by_path(params_to_tree(params, cfg), is_leaf=_is_t)
    assert list(got) == list(want)                      # the same leaves, in flatten order
    for k, v in want.items():
        assert str(got[k].dtype).removeprefix("torch.") == str(v.dtype), k
        assert np.array_equal(_np(got[k]), v.astype(np.float32)), k


def test_serving_stays_frozen_and_trainable_turns_every_parameter_on():
    cfg = smoke_config("jamba-v0.1-52b")
    params = M.init_params(cfg, 0, device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    M.trainable(params)
    assert all(p.requires_grad for p in params.parameters())
    # Mamba's A_log and D are parameters, as every reference leaf is
    names = {n.rsplit(".", 1)[-1] for n, _ in params.named_parameters()}
    assert {"A_log", "D", "router"} <= names


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "jamba-v0.1-52b", "xlstm-1.3b", "whisper-tiny"])
def test_remat_gives_the_same_gradients(arch):
    """Remat (a checkpoint per period; whisper: per decoder block) changes
    what is stored, not what is computed: bitwise on the CPU."""
    cfg = smoke_config(arch)
    params = M.trainable(M.init_params(cfg, 0, device="cpu"))
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in make_batch(cfg).items()}
    out = []
    for remat in (False, True):
        total, metrics, grads = TT.loss_and_grads(
            params, cfg, batch, TT.TrainSettings(remat=remat))
        out.append((total, grads))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


# ---- one train step of every architecture ----------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One step from the same weights and batch: loss and aux, every leaf's
    gradient, the leaves that get a gradient at all, the metrics, and the
    parameters and moments after the step (tolerances in the module
    docstring)."""
    jcfg, jparams, cfg, params = _pair(arch)
    batch = {k: np.asarray(v) for k, v in make_batch(jcfg).items()}
    jsettings = JT.TrainSettings(opt=JO.AdamWConfig(**OPT))
    (jtotal, jmetrics), jgrads = jax.value_and_grad(JT.loss_and_aux, has_aux=True)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, jsettings)
    jstep, _ = JT.make_train_step(jcfg, MESH, {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                                              for k, v in batch.items()}, jsettings)
    jp2, jopt2, jm = jax.jit(jstep)(jparams, JO.init_opt_state(jparams), batch)

    settings = TT.TrainSettings(opt=TO.AdamWConfig(**OPT))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    layout = reference_layout(params, cfg)
    total, metrics, grads = TT.loss_and_grads(params, cfg, tbatch, settings)
    assert abs(float(total) - float(jtotal)) <= 1e-5 * abs(float(jtotal))
    for k in ("loss", "lb_loss", "z_loss", "drop_frac"):
        assert abs(float(metrics[k]) - float(jmetrics[k])) <= 1e-5 * max(abs(float(jmetrics[k])),
                                                                        1e-6), k
    want_g = _leaves_by_path(jgrads)
    got_g = _leaves_by_path(to_reference_tree(grads, layout), is_leaf=_is_t)
    assert list(got_g) == list(want_g)
    assert ({k for k, v in got_g.items() if bool(v.abs().max() > 0)}
            == {k for k, v in want_g.items() if float(jnp.abs(v).max()) > 0})
    for k, v in want_g.items():
        _close_to_leaf_max(_np(got_g[k]), np.asarray(v, np.float32), LEAF_TOL, f"grad {k}")

    opt = TO.init_opt_state(params)
    _, opt, m = TT.make_train_step(cfg, settings=settings)(params, opt, tbatch)
    assert set(m) == set(jm) | {"total_loss"} == {"loss", "lb_loss", "z_loss", "drop_frac",
                                                  "grad_norm", "lr", "total_loss"}
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5 * float(jm["grad_norm"])
    assert float(m["lr"]) == float(jm["lr"]) and int(opt.step) == int(jopt2.step) == 1
    lr = float(jm["lr"])
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))
    for name, want, got in (("mu", jopt2.mu, opt.mu), ("nu", jopt2.nu, opt.nu)):
        got = _leaves_by_path(to_reference_tree(got, layout), is_leaf=_is_t)
        for k, v in _leaves_by_path(want).items():
            _close_to_leaf_max(_np(got[k]), np.asarray(v), 2 * LEAF_TOL, f"{name} {k}")
    got_p = _leaves_by_path(params_to_tree(params, cfg), is_leaf=_is_t)
    for k, v in _leaves_by_path(jp2).items():
        err = np.abs(_np(got_p[k]) - np.asarray(v, np.float32))
        sharp = np.abs(np.asarray(want_g[k], np.float32)) * clip > 1e-6
        assert float(err[sharp].max(initial=0.0)) <= 1e-6, f"param {k}"
        assert float(err.max()) <= 2 * lr + 1e-6, f"param {k}"
