"""The port's dry run (``repro_torch.launch.dryrun``, ``forest_dryrun``), its
roofline (``roofline/analysis.py``) and op counter (``roofline/counts.py``)
against the JAX package.

Full-size cells are checked by their static bytes only (the reference's
specs over a duck-typed mesh, its per-device formula written out here:
``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported, so no test imports it); only smoke configs are traced.  The
counter's FLOPs and bytes of a step on meta equal the same step run for real
on the CPU, and its collective bytes under the fake process group equal the
same step's over gloo at world size 4.
"""
import dataclasses
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _gloo_ranks import run_ranks
from _jax_caches import cleared_jax_caches  # noqa: F401  (autouse)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import shape_applicable as ref_applicable
from repro.dist import sharding as ref_shd
from repro.models import model as RM
from repro.roofline import analysis as ref_RA
from repro_torch.configs import SHAPES, ShapeSpec, get_config, list_archs, smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import counts as C

ARCHS = list_archs()
ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    """Duck-typed mesh (axis names and sizes only)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"pod": {"data": 16, "model": 16}, "multipod": {"pod": 2, "data": 16, "model": 16}}


def _ref_bf16(cfg):
    return dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16",
                               head_pad=16, vocab_pad_to=256)


def _flat_ref(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            (tuple(leaf.shape), str(np.dtype(leaf.dtype)))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree, path=()):
    if isinstance(tree, torch.Tensor):
        return {"/".join(map(str, path)): (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_port(v, path + (k,)))
    return out


def _stack_layers(cfg, cache: list) -> dict:
    """The port's per-layer LM cache in the reference's tree: one entry per
    pattern position, its leaves stacked over the periods."""
    n = len(cfg.block_pattern)
    out = {}
    for key, (shape, dt) in _flat_port(cache[:n]).items():
        out[key] = ((cfg.n_periods,) + shape, dt)
    for layer in range(n, len(cache)):               # every period alike
        for key, v in _flat_port(cache[layer]).items():
            assert (v[0], v[1]) == (out[f"{layer % n}/{key}"][0][1:], out[f"{layer % n}/{key}"][1])
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_param_count_equal_reference(arch):
    """``input_specs`` / ``cache_specs`` shapes and dtypes and
    ``exact_param_count`` for every shape at full size (the dry run's
    production numerics)."""
    cfg, ref = dryrun._bf16(get_config(arch)), _ref_bf16(ref_get_config(arch))
    assert M.exact_param_count(get_config(arch)) == RM.exact_param_count(ref_get_config(arch))
    for name, shape in SHAPES.items():
        assert _flat_port(M.input_specs(cfg, shape)) == _flat_ref(
            RM.input_specs(ref, REF_SHAPES[name])), name
        got = M.cache_specs(cfg, shape)
        if not cfg.is_encdec:
            got = _stack_layers(cfg, got)
        else:
            got = _flat_port(got)
        assert got == _flat_ref(RM.cache_specs(ref, REF_SHAPES[name])), name


def _ref_static_bytes(tree, specs, mesh, itemsize=None) -> int:
    """The reference's ``static_bytes_per_device`` (dryrun.py:35-50)."""
    total = 0
    for sds, spec in zip(jax.tree.leaves(tree),
                         jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))):
        n = int(np.prod(sds.shape)) if sds.shape else 1
        denom = 1
        for part in spec:
            if part is None:
                continue
            for ax in (part if isinstance(part, tuple) else (part,)):
                denom *= mesh.shape[ax]
        total += -(-n // denom) * (itemsize or np.dtype(sds.dtype).itemsize)
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_static_bytes_equal_reference_formula(arch):
    """Parameter, optimizer and cache bytes per device on the pod and the
    two-pod mesh, for every applicable cell: the port's rule table against
    the reference's formula over the reference's specs."""
    cfg, ref = dryrun._bf16(get_config(arch)), _ref_bf16(ref_get_config(arch))
    sds = RM.param_specs(ref)
    for kind, sizes in MESHES.items():
        fm = FakeMesh(sizes)
        assert dict(make_production_mesh(multi_pod=kind == "multipod").shape) == sizes
        pspecs = ref_shd.param_pspecs(ref, sds, fm)
        params = _ref_static_bytes(sds, pspecs, fm)
        ospecs = jax.tree.map(lambda s, l: ref_shd.opt_state_pspec(s, l.shape, fm), pspecs, sds,
                              is_leaf=lambda x: isinstance(x, P))
        opt = 2 * _ref_static_bytes(sds, ospecs, fm, itemsize=4)
        for name, shape in SHAPES.items():
            if not ref_applicable(ref, REF_SHAPES[name])[0]:
                continue
            want = {"params_bytes_dev": params}
            if shape.kind == "train":
                want["opt_bytes_dev"] = opt
            elif shape.kind == "decode":
                cache = RM.cache_specs(ref, REF_SHAPES[name])
                cspecs = ref_shd.cache_pspecs(ref, cache, fm, seq_shard=name == "long_500k")
                want["cache_bytes_dev"] = _ref_static_bytes(cache, cspecs, fm)
            assert dryrun.static_memory(cfg, shape, AbstractMesh(tuple(sizes),
                                                                 tuple(sizes.values()))) \
                == want, (kind, name)


def test_model_flops_equal_reference():
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            assert RA.model_flops(get_config(arch), shape) == ref_RA.model_flops(
                ref_get_config(arch), REF_SHAPES[name]), (arch, name)


def test_analyse_equals_reference_with_its_constants_set_to_the_h100(monkeypatch):
    monkeypatch.setattr(ref_RA, "PEAK_FLOPS", RA.H100_BF16_FLOP_PER_S)
    monkeypatch.setattr(ref_RA, "HBM_BW", RA.H100_BYTES_PER_S)
    monkeypatch.setattr(ref_RA, "ICI_BW", RA.NETWORK_BYTES_PER_S)
    for flops, nbytes, coll, mf in ((1e15, 1e11, 1e9, 5e17), (1e12, 1e13, 1e8, 1e14),
                                    (1e12, 1e9, 1e12, 1e16), (0.0, 0.0, 0.0, 0.0)):
        cost = {"flops": flops, "bytes accessed": nbytes}
        want = ref_RA.analyse(cost, {"total_bytes": coll}, n_chips=256,
                              model_flops_global=mf).to_dict()
        assert RA.analyse(cost, {"total_bytes": coll}, n_chips=256, model_flops_global=mf,
                          dtype="bfloat16").to_dict() == want
        # all over NVLink: the collective term at NVLink's rate
        got = RA.analyse(cost, {"total_bytes": coll, "by_link": {"nvlink": coll}},
                         n_chips=256, model_flops_global=mf)
        assert got.collective_s == coll / RA.NVLINK_BYTES_PER_S


def test_ring_multipliers_and_links():
    assert RA.ring_bytes("all-gather", 160, 16) == 150
    assert RA.ring_bytes("all-to-all", 160, 16) == 150
    assert RA.ring_bytes("all-reduce", 160, 16) == 300
    assert RA.ring_bytes("reduce-scatter", 10, 16) == 150
    assert RA.ring_bytes("exchange", 10, 16) == 10
    assert RA.ring_bytes("all-reduce", 10, 1) == 0
    assert not RA.spans_nodes(range(8)) and RA.spans_nodes(range(16))
    assert RA.spans_nodes(range(0, 256, 16))


def test_no_tpu_constant_in_the_port():
    import re
    for f in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        text = f.read_text()
        for bad in (r"197e12", r"819e9", r"\bICI\b", r"\bv5e\b", r"\bTPU v"):
            assert not re.search(bad, text), f"{f}: {bad}"


def test_flash_work_counts_the_visible_pairs():
    for sq, sk, causal in ((7, 7, True), (5, 9, True), (9, 5, True), (6, 4, False), (1, 1, True)):
        qpos = np.arange(sq) + (sk - sq)
        pairs = int(np.clip(qpos + 1, 0, sk).sum()) if causal else sq * sk
        nops, nbytes = C.flash_work(2, 4, 2, sq, sk, 8, causal, 4)
        assert nops == 4.0 * 2 * 4 * 8 * pairs
        assert nbytes == (2 * 2 * 4 * sq * 8 + 2 * 2 * 2 * sk * 8) * 4


def test_kernel_entry_counts_its_formula_and_hides_its_ops():
    from repro_torch.kernels.distance import pairwise_distance
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(2, 4, 6, 8, generator=g), torch.randn(2, 2, 6, 8, generator=g)
    rec = C.OpCounts()
    with rec:
        flash_attention_fwd(q, k, k, causal=True)
        pairwise_distance(q[0, 0], k[0, 0])
    kernels = {k for k in rec.ops if k.startswith("kernel:")}
    assert kernels == {"kernel:flash_attention_fwd", "kernel:pairwise_distance"}
    # outside the kernels: the test's indexing and the Function's detach,
    # views that move nothing
    assert {k: v for k, v in rec.ops.items() if k not in kernels} == {
        "aten.detach": [3, 0.0, 0.0], "aten.select": [4, 0.0, 0.0]}
    assert rec.kernels["flash_attention_fwd"]["flops"] == C.flash_work(
        2, 4, 2, 6, 6, 8, True, 4)[0]
    assert rec.kernels["pairwise_distance"]["bytes"] == C.distance_work(6, 6, 8, False)[1]
    # on meta: the same counts, empty outputs
    rec2 = C.OpCounts()
    with rec2:
        out = flash_attention_fwd(q.to("meta"), k.to("meta"), k.to("meta"), causal=True)
    assert out.device.type == "meta" and out.shape == q.shape
    assert rec2.kernels["flash_attention_fwd"] == rec.kernels["flash_attention_fwd"]


def _smoke_cell(arch, kind, s=16, b=4):
    return ShapeSpec(f"smoke_{kind}", s, b, kind)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_counts_equal_a_real_cpu_step(kind, tmp_path):
    """A smoke cell at mesh (1, 1): the dry run's counts on meta equal one
    real step of the same program on the CPU under the same recorder (a
    one-rank gloo group)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    shape, mesh = _smoke_cell("qwen2.5-3b", kind), AbstractMesh(("data", "model"), (1, 1))
    rec = dryrun.run_cell("qwen2.5-3b", shape.name, "1x1", shape=shape, mesh=mesh, smoke=True,
                          save=False, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    cfg = dryrun._bf16(smoke_config("qwen2.5-3b"))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0, world_size=1)
    try:
        run, static = dryrun.build_cell(cfg, shape, mesh, make_host_mesh(1, 1, device="cpu"),
                                        device="cpu")
        real, _ = dryrun.count_step(run)
    finally:
        dist.destroy_process_group()
    assert static == {k: v for k, v in rec["static_memory"].items() if k != "total_bytes_dev"}
    for key in ("flops", "bytes", "collectives", "collective_counts", "kernels", "n_ops"):
        assert real[key] == rec["counts"][key], key
    assert real["flops"] > 0 and real["bytes"] > 0
    if kind != "decode":
        assert real["kernels"]["flash_attention_fwd"]["calls"] == (
            4 if kind == "train" else 2)       # remat recomputes each forward


_GLOO_CELLS = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh
rank, init, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4)
from repro_torch.configs import smoke_config
out = {}
import dataclasses
for arch, kind in %r:
    shape = ShapeSpec("smoke_" + kind, 16, 4, kind)
    cfg = smoke_config(arch)
    cfg = dryrun._bf16(dataclasses.replace(cfg, n_layers=len(cfg.block_pattern)))
    run, _ = dryrun.build_cell(cfg, shape, AbstractMesh(("data", "model"), (2, 2)),
                               make_host_mesh(2, 2, device="cpu"), device="cpu")
    out[arch + "/" + kind] = dryrun.count_step(run)[0]
np.savez(f"{d}/out.{rank}.npz", totals=np.array(json.dumps(out)))
dist.destroy_process_group()
print("RANK_DONE", rank)
"""
# jamba's period holds every kind of collective the sharded step runs:
# attention and FFN by head and hidden dim, the MoE, the Mamba regroup
GLOO_CELLS = [("jamba-v0.1-52b", "train")]


def test_collectives_on_the_fake_group_equal_gloo_world_4(tmp_path):
    """A smoke cell at (2, 2), one period of jamba: rank 0's collective
    bytes and counts by op (and its FLOPs and bytes) under the fake group
    on meta equal the same step over gloo at world size 4 on the CPU; its
    Mamba layers regroup their fused projection by the point-to-point
    exchange."""
    ranks = run_ranks(_GLOO_CELLS % (GLOO_CELLS,), tmp_path)
    gloo = json.loads(str(ranks[0]["totals"]))
    mesh = AbstractMesh(("data", "model"), (2, 2))
    for arch, kind in GLOO_CELLS:
        shape, cfg = _smoke_cell(arch, kind), smoke_config(arch)
        cfg = dryrun._bf16(dataclasses.replace(cfg, n_layers=len(cfg.block_pattern)))
        with dryrun.fake_world(4):
            run, _ = dryrun.build_cell(cfg, shape, mesh, dryrun.device_mesh(2, 2))
            got, _ = dryrun.count_step(run)
        want = gloo[f"{arch}/{kind}"]
        for key in ("collectives", "collective_counts", "by_link", "flops", "bytes"):
            assert got[key] == want[key], (arch, kind, key)
        assert got["collective_bytes"] > 0 and got["by_link"]["network"] == 0
    assert gloo["jamba-v0.1-52b/train"]["collective_counts"]["exchange"] > 0


def test_slstm_trip_scaling_equals_the_full_count():
    """xlstm's sLSTM loop traced for 2 and 3 steps and extrapolated to s
    equals the loop traced whole (a train step: the forward, remat's
    recompute and the backward), at small s, on one period."""
    mesh = AbstractMesh(("data", "model"), (1, 1))
    cfg = smoke_config("xlstm-1.3b")
    cfg = dryrun._bf16(dataclasses.replace(cfg, n_layers=len(cfg.block_pattern)))
    assert "slstm" in cfg.block_pattern
    for kind in ("train",):
        shape = ShapeSpec("s", 5, 1, kind)
        with dryrun.fake_world(1):
            run, _ = dryrun.build_cell(cfg, shape, mesh, dryrun.device_mesh(1, 1))
            scaled, scaled_ops = dryrun.count_step(run)
            full, full_ops = dryrun.count_step(run, loop_steps=None)
        assert scaled.pop("loop_trips") == {"trips": 5, "traced": [2, 3]}
        assert "loop_trips" not in full
        assert scaled == full, kind
        assert scaled_ops == full_ops, kind


def test_list_and_the_long_context_skip(capsys):
    assert dryrun.main(["--list"]) == []
    lines = capsys.readouterr().out.split("\n")
    assert [ln for ln in lines if ln] == [f"{a} {s}" for a in ARCHS for s in SHAPES]
    skipped = 0
    for arch in ARCHS:
        ok, why = ref_applicable(ref_get_config(arch), REF_SHAPES["long_500k"])
        if ok:                      # the two sub-quadratic archs: traced elsewhere
            continue
        rec = dryrun.run_cell(arch, "long_500k", "pod", save=False, verbose=False)
        assert (rec["status"], rec["reason"], rec["n_chips"]) == ("skipped", why, 256)
        skipped += 1
    assert skipped == 8


def test_forest_dryrun_shards_equal_the_reference_build(tmp_path):
    """The forest dry run at small n on the CPU: its 16 shards' heights and
    node counts equal the reference's ``build_forest_trees`` on the same X;
    the rank's step is bitwise to the plain scorer's, its counts recorded."""
    from repro.core.distributed import build_forest_trees
    from repro_torch.launch import forest_dryrun
    n, dim = 4000, 8
    rec = forest_dryrun.main(["--n", str(n), "--dim", str(dim), "--batch", "16",
                              "--device", "cpu", "--out", str(tmp_path)])
    X = np.random.default_rng(0).random((n, dim), np.float32)
    trees = build_forest_trees(X, 16, capacity=32, metric="l2")
    assert rec["heights"] == [int(t.height) for t in trees]
    assert rec["n_nodes"] == [int(t.n_nodes) for t in trees]
    assert rec["bitwise_vs_plain"] and rec["counts"]["collective_counts"] == {"all-gather": 2}
    assert rec["counts"]["kernels"]["frontier_scores"]["calls"] > 0
    assert rec["useful_flops"] == 16 * max(rec["heights"]) * 64 * 32 * 2 * dim / 256
    assert json.loads((tmp_path / "forest_knn__base.json").read_text())["heights"] == \
        rec["heights"]


def test_records_keep_the_reference_fields(tmp_path):
    rec = dryrun.run_cell("whisper-tiny", "decode_32k", "pod", out_dir=tmp_path, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    for key in ("static_memory", "collectives", "roofline", "params", "active_params",
                "trace_s", "n_chips", "mesh_shape"):
        assert key in rec
    assert "memory_analysis" not in rec and not any(k.startswith("hlo") for k in rec)
    assert set(rec["roofline"]) == set(ref_RA.Roofline.__dataclass_fields__)
    assert rec["params"] == 36_620_160 and rec["program_mesh"] == {"data": 16, "model": 16}
    assert math.isclose(rec["roofline"]["model_flops"],
                        RA.model_flops(get_config("whisper-tiny"), SHAPES["decode_32k"]) / 256)
    saved = json.loads((tmp_path / "whisper-tiny__decode_32k__pod.json").read_text())
    assert saved["roofline"] == rec["roofline"]
