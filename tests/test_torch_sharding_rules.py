"""The port's sharding rule table against the reference's, entry for
entry: every arch of ``configs/all_archs.py`` at full and smoke size, with
``moe_ep`` off and on, on duck-typed meshes from (1, 1) to the production
(16, 16) and the two-pod (2, 16, 16).  Pure: no process group, no device;
the reference's shapes come from ``M.param_specs`` (``jax.eval_shape``), the
port's from its model built on the meta device.  The reference's own rule
tests (tests/test_sharding_rules.py) are mirrored at the end.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _jax_caches import cleared_jax_caches  # noqa: F401
from repro.configs import all_archs as ref_archs
from repro.configs.base import SHAPES, ShapeSpec
from repro.configs.base import get_config as ref_get_config
from repro.dist import sharding as ref_shd
from repro.models import model as RM
from repro_torch.configs import get_config, smoke_config
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.models import model as M


class FakeMesh:
    """Duck-typed mesh (axis names and sizes only)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"1x1": {"data": 1, "model": 1}, "2x2": {"data": 2, "model": 2},
          "4x2": {"data": 4, "model": 2}, "2x4": {"data": 2, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _arch_names():
    from repro.configs.base import list_archs
    return list_archs()


ARCHS = _arch_names()
SIZES = ("full", "smoke")


def _cfgs(arch, size, ep):
    ref = ref_get_config(arch) if size == "full" else ref_archs.smoke_config(arch)
    port = get_config(arch) if size == "full" else smoke_config(arch)
    if ep:
        ref, port = (dataclasses.replace(c, moe_ep=True) for c in (ref, port))
    return ref, port


@functools.lru_cache(maxsize=None)
def _shapes(arch, size, ep):
    """(reference ShapeDtypeStruct tree, port model on meta)."""
    ref, port = _cfgs(arch, size, ep)
    return RM.param_specs(ref), M.param_specs(port)


def _flat_ref(specs):
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = tuple(s)
    return out


def _flat_port(specs, path=()):
    if isinstance(specs, shd.Spec):
        return {"/".join(str(k) for k in path): tuple(specs)}
    items = specs.items() if isinstance(specs, dict) else enumerate(specs)
    out = {}
    for k, v in items:
        out.update(_flat_port(v, path + (k,)))
    return out


def _meta(tree):
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), tree)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("ep", [False, True], ids=["dense", "moe_ep"])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_reference(arch, size, ep, mesh):
    ref_cfg, cfg = _cfgs(arch, size, ep)
    sds, model = _shapes(arch, size, ep)
    fm = FakeMesh(MESHES[mesh])
    want = _flat_ref(ref_shd.param_pspecs(ref_cfg, sds, fm))
    got_specs = shd.param_pspecs(cfg, model, fm)
    got = _flat_port(got_specs)
    assert got == want
    # ZeRO-1 moments, leaf by leaf
    shapes = {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): l.shape
              for path, l in jax.tree_util.tree_flatten_with_path(sds)[0]}
    for key, spec in got.items():
        assert tuple(shd.opt_state_pspec(shd.Spec(spec), shapes[key], fm)) == \
            tuple(ref_shd.opt_state_pspec(P(*spec), shapes[key], fm)), key


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_cache_logits_query_specs_equal_reference(arch, size, mesh):
    ref_cfg, cfg = _cfgs(arch, size, False)
    fm = FakeMesh(MESHES[mesh])
    shapes = ([ShapeSpec("smoke", 64, 8, "decode")] if size == "smoke"
              else [SHAPES["decode_32k"], SHAPES["long_500k"]])
    for shape in shapes:
        for kind in ("train", "prefill", "decode"):
            sh = dataclasses.replace(shape, kind=kind)
            inputs = RM.input_specs(ref_cfg, sh)
            want = {k: tuple(v) for k, v in
                    ref_shd.input_pspecs(ref_cfg, kind, inputs, fm).items()}
            got = {k: tuple(v) for k, v in
                   shd.input_pspecs(cfg, kind, _meta(inputs), fm).items()}
            assert got == want, (kind, shape)
        cache = RM.cache_specs(ref_cfg, shape)
        for seq_shard in (False, True):
            want = _flat_ref(ref_shd.cache_pspecs(ref_cfg, cache, fm, seq_shard=seq_shard))
            got = _flat_port(shd.cache_pspecs(cfg, _meta(cache), fm, seq_shard=seq_shard))
            assert got == want, (shape, seq_shard)
        for b in (1, 4, 8, 12, 32, 128, shape.global_batch):
            assert tuple(shd.query_pspecs(fm, b)) == tuple(ref_shd.query_pspecs(fm, b))
    assert tuple(shd.logits_pspec(fm)) == tuple(ref_shd.logits_pspec(fm))
    assert shd.batch_dp(fm) == ref_shd.batch_dp(fm)


@pytest.mark.parametrize("mesh", ["2x2", "4x2", "16x16"])
@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "whisper-tiny"])
def test_port_cache_specs_are_the_stacked_specs_per_layer(arch, mesh):
    """The port's per-layer cache of a decoder LM gets its pattern slot's
    stacked spec with the period axis taken off."""
    ref_cfg, cfg = _cfgs(arch, "smoke", False)
    fm = FakeMesh(MESHES[mesh])
    cache = M.init_cache(cfg, 8, 64, device="meta")
    want = ref_shd.cache_pspecs(ref_cfg, RM.cache_specs(ref_cfg, ShapeSpec("s", 64, 8, "decode")),
                                fm)
    got = shd.layer_cache_specs(cfg, cache, fm)
    n = len(cfg.block_pattern)
    for layer, specs in enumerate(got):
        w = jax.tree.map(lambda s: tuple(s)[1:], want[layer % n],
                         is_leaf=lambda x: isinstance(x, P))
        assert jax.tree.map(tuple, specs, is_leaf=lambda x: isinstance(x, shd.Spec)) == w


@pytest.mark.parametrize("mesh", ["1x1", "2x2", "4x2", "2x4", "16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_specs_drop_the_period_axis(arch, mesh):
    """``layer_specs`` of each named parameter is its stacked leaf's spec
    without axis 0; the moments' owner names the layer's data rank where
    ZeRO-1 put 'data' on the period axis."""
    _, cfg = _cfgs(arch, "full", False)
    model = M.param_specs(cfg)
    fm = FakeMesh(MESHES[mesh])
    from repro_torch.models.convert import reference_layout
    flat = _flat_port(shd.param_pspecs(cfg, model, fm))
    specs = shd.layer_specs(cfg, model, fm)
    opt = shd.layer_specs(cfg, model, fm, opt=True)
    for name, (path, idx) in reference_layout(model, cfg).items():
        stacked = flat["/".join(str(k) for k in path)]
        assert tuple(specs[name]) == (stacked if idx is None else stacked[1:])
        spec, owner = opt[name]
        if owner is not None:
            axes, index = owner
            assert axes == ("data",) and 0 <= index < MESHES[mesh]["data"]
            n = shd._n_stacked(cfg, path) // MESHES[mesh]["data"]
            assert idx // n == index


def test_production_mesh_shapes():
    m = make_production_mesh()
    assert dict(m.shape) == {"data": 16, "model": 16} and m.axis_names == ("data", "model")
    p = make_production_mesh(multi_pod=True)
    assert dict(p.shape) == {"pod": 2, "data": 16, "model": 16}
    assert dp_axes(p) == ("pod", "data") and dp_axes(m) == ("data",)
    assert shd.batch_dp(p) == ("pod", "data")


@pytest.mark.parametrize("spec,want", [
    (("model", None), ("Replicate", "Shard(0)")),
    ((None, "data", "model"), ("Shard(1)", "Shard(2)")),
    ((("pod", "data"), None), ("Shard(0)", "Shard(0)", "Replicate")),
    ((None,), ("Replicate", "Replicate"))])
def test_placements(spec, want):
    mesh = make_production_mesh(multi_pod=len(want) == 3)
    got = shd.placements(shd.Spec(spec), mesh)
    names = tuple("Replicate" if type(p).__name__ == "Replicate" else f"Shard({p.dim})"
                  for p in got)
    assert names == want


@pytest.mark.parametrize("mesh", ["2x2", "4x2", "2x4", "pod2x16x16"])
def test_local_slices_tile_the_leaf(mesh):
    """Every coordinate's slices together cover each element exactly as
    many times as the leaf is replicated."""
    fm = FakeMesh(MESHES[mesh])
    sizes = MESHES[mesh]
    shape = (64, 32, 16)
    for spec in [("model", ("pod", "data") if "pod" in sizes else "data", None),
                 (None, "model", None), (None, None, None)]:
        count = np.zeros(shape, np.int64)
        for flat in np.ndindex(*sizes.values()):
            coords = dict(zip(sizes, flat))
            count[shd.local_slices(shd.Spec(spec), shape, fm, coords)] += 1
        used = shd._used_axes(spec)
        rep = int(np.prod([s for a, s in sizes.items() if a not in used]))
        assert (count == rep).all(), spec


# ---- the reference's rule tests, on the port ----------------------------
PROD = FakeMesh({"data": 16, "model": 16})


def _prod_specs(arch, **over):
    cfg = get_config(arch, head_pad=16, vocab_pad_to=256, **over)
    return cfg, _flat_port(shd.param_pspecs(cfg, M.param_specs(cfg), PROD))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_spec_divides_evenly(arch):
    cfg, flat = _prod_specs(arch)
    ref = RM.param_specs(ref_get_config(arch, head_pad=16, vocab_pad_to=256))
    shapes = {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): l.shape
              for path, l in jax.tree_util.tree_flatten_with_path(ref)[0]}
    for key, spec in flat.items():
        for i, part in enumerate(spec):
            total = int(np.prod([PROD.shape[a] for a in shd._axes_of(part)]))
            assert shapes[key][i] % total == 0, (arch, key, spec)


def test_attention_rules():
    _, flat = _prod_specs("yi-34b")
    wq = next(v for k, v in flat.items() if k.endswith("attn/wq"))
    assert wq[-2] == "model", wq
    wk = next(v for k, v in flat.items() if k.endswith("attn/wk"))
    assert "model" not in shd._used_axes(wk), wk


def test_embed_vocab_sharded_no_fsdp():
    _, flat = _prod_specs("qwen2.5-3b")
    emb = flat["embed"]
    assert emb[0] == "model" and (len(emb) < 2 or emb[1] is None), emb


def test_moe_ep_switches_expert_axis():
    _, flat = _prod_specs("grok-1-314b")
    wi = next(v for k, v in flat.items() if k.endswith("moe/wi"))
    assert wi[-1] == "model" and wi[-3] != "data", wi
    _, flat_ep = _prod_specs("grok-1-314b", moe_ep=True, expert_pad_to=16)
    wi_ep = next(v for k, v in flat_ep.items() if k.endswith("moe/wi"))
    assert wi_ep[-3] == "data", wi_ep


def test_zero1_extends_with_data():
    spec = shd.opt_state_pspec(shd.Spec((None, "model")), (4096, 1024), PROD)
    assert spec[0] == "data" and spec[1] == "model", spec


def test_big_params_get_fsdp():
    _, flat = _prod_specs("yi-34b")
    wq = next(v for k, v in flat.items() if k.endswith("attn/wq"))
    assert "data" in shd._used_axes(wq), wq


def test_cache_specs_seq_sharding():
    ref_cfg = ref_get_config("jamba-v0.1-52b", head_pad=16, vocab_pad_to=256)
    cfg = get_config("jamba-v0.1-52b", head_pad=16, vocab_pad_to=256)
    cache = _meta(RM.cache_specs(ref_cfg, SHAPES["long_500k"]))
    specs = shd.cache_pspecs(cfg, cache, PROD, seq_shard=True)
    kv = [s for s in _flat_port(specs).values() if len(s) == 5]
    assert kv, "jamba must have KV caches"
    assert all(s[3] is not None for s in kv), kv


def test_constrain_is_identity():
    x = torch.ones(4, 6)
    with shd.use_mesh(PROD):
        assert shd._ambient_mesh() is PROD
        assert shd.constrain(x, "data", "model") is x
    assert shd._ambient_mesh() is None


def test_local_slices_take_the_linear_index_and_refuse_an_uneven_split():
    """A rank's slice of a dim split over two axes is its linear index over
    them, outermost first (the sharded decode's cache offset reads the
    same ``shard_index``); a dim that does not split evenly raises rather
    than dropping its tail."""
    mesh = make_production_mesh()
    coords = {"data": 1, "model": 3}
    spec = shd.Spec((("model", "data"), "model"))
    assert shd.shard_index(spec[0], mesh, coords) == (3 * 16 + 1, 256)
    assert shd.local_slices(spec, (512, 32), mesh, coords) == (slice(98, 100), slice(6, 8))
    with pytest.raises(ValueError, match="does not split"):
        shd.local_slices(shd.Spec(("data", None)), (24, 5), mesh, coords)
