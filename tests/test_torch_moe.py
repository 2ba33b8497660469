"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe`` on the CPU.

Both get the same numpy weights (the JAX ``moe_init``) and inputs (numpy,
seeded).  ``y`` and the three aux values within 1e-4 in float32; the
gate indices equal, the JAX ones from ``lax.top_k`` of the reference's
float32 router probabilities; in bfloat16, ``y`` within 2 bf16 ulps of
its largest |value|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.all_archs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import moe as J  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import MLP, Dense  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

TOL = 1e-4


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _port(p) -> moe.MoE:
    shared = None
    if "shared" in p:
        s = {k: Dense(_t(v["w"])) for k, v in p["shared"].items()}
        shared = MLP(s["wi"], s["wo"], s["wg"])
    return moe.MoE(_t(p["router"]), _t(p["wi"]), _t(p["wg"]), _t(p["wo"]), shared)


def _case(arch, b=2, s=24, seed=0, dup_columns=False, **overrides):
    jcfg = dataclasses.replace(jax_smoke_config(arch), **overrides)
    cfg = dataclasses.replace(smoke_config(arch), **overrides)
    dtype = jnp.dtype(jcfg.param_dtype)
    jp = J.moe_init(jax.random.PRNGKey(seed), jcfg, dtype)
    if dup_columns:          # a tie-heavy router: expert 2j + 1 copies 2j
        r = np.array(jp["router"])
        r[:, 1::2] = r[:, 0:-1:2][:, :r[:, 1::2].shape[1]]
        jp = dict(jp, router=jnp.asarray(r))
    x = np.random.default_rng(seed + 1).normal(size=(b, s, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return jcfg, jp, jx, cfg, _port(jp), _t(jx)


def _jax_gates(jp, jcfg, jx):
    """The reference's routing choices (``moe_apply``'s first lines)."""
    logits = jx.reshape(-1, jx.shape[-1]).astype(jnp.float32) @ jp["router"]
    E = jcfg.padded_experts
    if E != jcfg.n_experts:
        logits = jnp.where(jnp.arange(E)[None] >= jcfg.n_experts, -1e30, logits)
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1), jcfg.experts_per_token)[1])


def _check(jcfg, jp, jx, cfg, p, x, capacity=None, tol=TOL):
    want, waux = J.moe_apply(jp, jcfg, jx, capacity)
    routing = []
    got, aux = moe.moe_apply(p, cfg, x, capacity, _routing=routing)
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_array_equal(routing[0]["gate_i"].numpy(), _jax_gates(jp, jcfg, jx))
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), w, rtol=tol, atol=tol)
    for k in ("lb_loss", "z_loss", "drop_frac"):
        np.testing.assert_allclose(float(aux[k]), float(waux[k]), rtol=TOL, atol=TOL,
                                   err_msg=k)
    return aux, routing[0]


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b"])
@pytest.mark.parametrize("capacity", [None, 3, 1])
def test_moe_apply_drops_like_the_reference(arch, capacity):
    """The config's capacity factor and forced small capacities: tokens
    over an expert's capacity are dropped, their slots get zeros."""
    aux, routing = _check(*_case(arch), capacity=capacity)
    if capacity is not None:
        assert float(aux["drop_frac"]) > 0.5
        T, k = 2 * 24, 2
        assert int((~routing["keep"]).sum()) == round(float(aux["drop_frac"]) * T * k)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b"])
def test_moe_decode_capacity_is_dropless(arch):
    case = _case(arch, b=5, s=1)
    aux, routing = _check(*case, capacity=5)
    assert float(aux["drop_frac"]) == 0.0 and bool(routing["keep"].all())


@pytest.mark.parametrize("pad_to", [3, 16])
def test_moe_padded_experts_never_win(pad_to):
    case = _case("grok-1-314b", expert_pad_to=pad_to)
    jcfg = case[0]
    assert jcfg.padded_experts > jcfg.n_experts
    _, routing = _check(*case)
    assert int(routing["gate_i"].max()) < jcfg.n_experts


@pytest.mark.parametrize("arch,shared", [("qwen2-moe-a2.7b", True), ("grok-1-314b", False)])
def test_moe_shared_experts_on_and_off(arch, shared):
    jcfg, jp, jx, cfg, p, x = _case(arch)
    assert (p.shared is not None) == shared == ("shared" in jp)
    _check(jcfg, jp, jx, cfg, p, x)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b"])
def test_moe_ties_take_the_lower_expert_first(arch):
    """Duplicate router columns make exact ties: the order is
    ``lax.top_k``'s (the lower index first), not whatever topk gives."""
    case = _case(arch, dup_columns=True)
    _, routing = _check(*case)
    g = routing["gate_i"]
    # every pair (2j, 2j + 1) ties; a token that picks both lists 2j first
    both = (g[:, 0] // 2 == g[:, 1] // 2) & (g[:, 0] != g[:, 1])
    assert bool(both.any()) and bool((g[both, 0] < g[both, 1]).all())


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b"])
def test_moe_bf16_on_identical_inputs(arch):
    jcfg, jp, jx, cfg, p, x = _case(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    assert p.router.dtype == torch.float32 and p.wi.dtype == torch.bfloat16
    want, _ = J.moe_apply(jp, jcfg, jx)
    top = float(np.abs(np.asarray(want.astype(jnp.float32))).max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)        # bf16: 8 significant bits
    _check(jcfg, jp, jx, cfg, p, x, tol=2 * ulp)


def test_moe_ep_without_a_group_is_moe_apply():
    """The reference's ``moe_ep=True`` without a mesh calls ``moe_apply_ep``,
    which calls ``moe_apply`` again with ``capacity=None``: it recurses
    until Python stops it.  The port computes the reference's evident
    intent, its ``moe_ep=False`` answer."""
    jcfg, jp, jx, cfg, p, x = _case("qwen2-moe-a2.7b", moe_ep=True)
    with pytest.raises(RecursionError):
        J.moe_apply(jp, jcfg, jx)
    _check(dataclasses.replace(jcfg, moe_ep=False), jp, jx, cfg, p, x)


def test_moe_init_shapes_and_dtypes():
    kw = dict(param_dtype="bfloat16", expert_pad_to=3)
    cfg = dataclasses.replace(smoke_config("qwen2-moe-a2.7b"), **kw)
    gen = torch.Generator().manual_seed(0)
    p = moe.MoE.init(cfg, torch.bfloat16, generator=gen, device="cpu")
    jcfg = dataclasses.replace(jax_smoke_config("qwen2-moe-a2.7b"), **kw)
    jp = J.moe_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    got = {n: (tuple(t.shape), str(t.dtype).split(".")[1]) for n, t in p.named_parameters()}
    want = {".".join(k.key for k in path): (tuple(a.shape), str(a.dtype))
            for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert got == want
    assert float(p.router.abs().max()) <= 2.0 * cfg.d_model ** -0.5 + 1e-6
