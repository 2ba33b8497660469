"""The sharded train step and the mesh checkpoints over gloo at world size
4 on the CPU, against the JAX package's one-device step.

Four ranks start as subprocesses that meet through a ``file://`` init
(``tests/test_torch_forest_dist.py``'s pattern) and write their results
to ``.npz`` files.  The model is the reference's ``scenario_train_step_
sharded`` one (qwen2.5-3b smoke cut to two ``attn`` layers) on a (2, 2)
{data, model} mesh; its weights are the JAX init, carried to the ranks as
an ``.npz`` of the reference's tree.  The reference's own sharded step
fails under jax 0.9.0 here (ROADMAP, reference caveats), so the sharded
port is held to the one-device JAX step, which ``test_torch_train.py``
already holds the one-device port to.  NCCL needs a card a rank and is
not exercised here.

Tolerances, each stated where it is used: the loss and the grad norm
within 1e-5 relative (sums over ranks change the order of reduction;
observed ~5e-7 and ~2e-6); a parameter after the step within 1e-6 where
the clipped gradient is above 1e-6 and within 2 lr elsewhere
(``test_torch_train.py``'s rule: Adam's g / (|g| + eps) turns on the last
digits of a small g); the int8 hook on shards bitwise the hook on the
whole gradient (one shared scale); the int8 step's parameters within 2 lr
and its residuals within one quantisation step of the one-device step's.
"""
import dataclasses
import json
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the rank subprocesses also stop at their own communicate() timeouts
pytestmark = pytest.mark.timeout(600)

from _gloo_ranks import WORLD, finish_ranks, start_ranks  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)
from _once import claim, once, shared_root  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)
from repro.configs.all_archs import smoke_config as jax_smoke_config  # noqa: E402
from repro.dist import checkpoint as jckpt  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JT  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.dist.compression import init_ef_state  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax, reference_layout  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import train_step as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
B, S = 8, 32


def configs():
    over = dict(n_layers=2, block_pattern=("attn",))
    return (dataclasses.replace(jax_smoke_config("qwen2.5-3b"), **over),
            dataclasses.replace(smoke_config("qwen2.5-3b"), **over))


def moe_config(ep: bool = True):
    """qwen2-moe's smoke model: expert-parallel at a dropless capacity, or
    dense dispatch at its own capacity (1.25)."""
    cfg = smoke_config("qwen2-moe-a2.7b")
    return dataclasses.replace(cfg, moe_ep=True, capacity_factor=64.0) if ep else cfg


def batch():
    cfg = configs()[1]
    rng = np.random.default_rng(3)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def flat_tree(tree, prefix=""):
    """A reference-shaped tree as {"a/b/0/c": array}."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in
                flat_tree(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in
                flat_tree(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def unflat_tree(flat):
    """The inverse of ``flat_tree`` (lists where the keys are positions)."""
    root: dict = {}
    for key, v in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {tests!r})
torch.set_num_threads(1)
import test_torch_train_sharded as tts
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.dist import sharding as shd
from repro_torch.dist.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.dist.compression import compressed_mean_hook
from repro_torch.dist.parallel import ShardedLM
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.models.convert import (from_reference_tree, params_from_jax, reference_layout,
                                        to_reference_tree)
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TT

rank, init, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size={world})
try:
    _, cfg = tts.configs()
    init_tree = tts.unflat_tree(dict(np.load(d + "/init.npz")))
    bt = {{k: torch.from_numpy(v) for k, v in np.load(d + "/batch.npz").items()}}
    mesh = make_host_mesh(2, 2, device="cpu")
    layout = reference_layout(M.param_specs(cfg), cfg)
    res = {{}}

    def start(**kw):
        params = ShardedLM.from_model(params_from_jax(init_tree, cfg, device="cpu"), cfg,
                                      mesh, requires_grad=True)
        opt = TT.init_sharded_opt(params, cfg, mesh)
        settings = TT.TrainSettings(opt=TO.AdamWConfig(**tts.OPT), **kw)
        step, sh = TT.make_train_step(cfg, mesh, bt, settings)
        return params, opt, step, sh

    def full_params(params, tag):
        for k, v in tts.flat_tree(to_reference_tree(params.gather(), layout)).items():
            res[tag + ":" + k] = v

    # one step, without and with sequence parallelism
    for tag, kw in (("step", {{}}), ("sp", dict(seq_parallel=True))):
        params, opt, step, sh = start(**kw)
        params, opt, m = step(params, opt, bt)
        for k in ("loss", "grad_norm", "lr", "total_loss"):
            res[tag + "_" + k] = m[k].numpy()
        res[tag + "_used_sp"] = np.asarray(params.sp)
        full_params(params, tag)
        if tag == "step":
            # every rank's shards are the table's slices of the gathered state
            full = params.gather()
            bad = [n for n, t in params.named_parameters()
                   if not torch.equal(t.detach(), full[n][shd.local_slices(
                       params.specs[n], full[n].shape, mesh)])]
            # the state gathered to each rank's host in turn (a checkpoint
            # write gathers to rank 0 only); None on the other ranks
            for dst in range({world}):
                got = TT.gather_state(params, opt, cfg, mesh, dst=dst)
                if dst != rank:
                    bad += [] if got is None else ["state on a rank that is not dst"]
                    continue
                fp, fmu, fnu = got
                bad += [n for n, t in fp.items() if t.device.type != "cpu"
                        or not torch.equal(t, full[n])]
            for name, (mspec, owner, _) in TT.moment_layout(cfg, mesh).items():
                for mine, whole in ((opt.mu, fmu), (opt.nu, fnu)):
                    if name in mine and not torch.equal(mine[name], whole[name][
                            shd.local_slices(mspec, whole[name].shape, mesh)]):
                        bad.append("moment " + name)
            # the table's shards of the whole initial tree (shard_tree) are
            # the runtime's per-layer shards before the step
            torch_tree = tts.unflat_tree({{k: torch.from_numpy(v) for k, v in
                                          tts.flat_tree(init_tree).items()}})
            shards = from_reference_tree(shd.shard_tree(
                torch_tree, shd.param_pspecs(cfg, M.param_specs(cfg), mesh), mesh), layout)
            first = start()[0]
            bad += [n for n, t in first.named_parameters()
                    if not torch.equal(t.detach(), shards[n])]
            res["bad_shards"] = np.asarray(len(bad))
            res["n_sharded"] = np.asarray(sum(t.numel() < full[n].numel()
                                              for n, t in params.named_parameters()))
            for k, v in tts.flat_tree(to_reference_tree(fmu, layout)).items():
                res["mu:" + k] = v

    # the int8 hook on this rank's shards of one whole gradient
    params, _, _, _ = start()
    rng = np.random.default_rng(11)
    whole = {{n: torch.from_numpy(rng.normal(size=params.shapes[n]).astype(np.float32))
             for n, _ in params.named_parameters()}}
    groups = {{}}
    for name, (path, _) in layout.items():
        groups.setdefault(path, []).append(name)
    local = {{n: whole[n][shd.local_slices(params.specs[n], whole[n].shape, mesh)]
             for n in whole}}
    got, ef = compressed_mean_hook(local, groups=list(groups.values()),
                                   ef={{n: torch.zeros_like(t) for n, t in local.items()}},
                                   group=dist.group.WORLD)
    want, want_ef = compressed_mean_hook(whole, groups=list(groups.values()),
                                         ef={{n: torch.zeros_like(t) for n, t in whole.items()}})
    res["hook_bad"] = np.asarray(sum(
        not torch.equal(got[n], want[n][shd.local_slices(params.specs[n], whole[n].shape, mesh)])
        or not torch.equal(ef[n], want_ef[n][shd.local_slices(params.specs[n], whole[n].shape,
                                                               mesh)]) for n in whole))

    # one int8 step with error feedback
    params, opt, step, sh = start(grad_compression="int8", error_feedback=True)
    ef = {{n: torch.zeros_like(t.detach()) for n, t in params.named_parameters()}}
    params, opt, ef, m = step(params, opt, ef, bt)
    res["int8_loss"], res["int8_grad_norm"] = m["loss"].numpy(), m["grad_norm"].numpy()
    full_params(params, "int8")
    full_ef = {{n: shd.gather_tensor(t, params.specs[n], params.shapes[n], mesh)
               for n, t in ef.items()}}
    for k, v in tts.flat_tree(to_reference_tree(full_ef, layout)).items():
        res["int8_ef:" + k] = v

    # the MoE block, its experts over 'data' (moe_apply_ep) and their
    # hidden dim over 'model'
    mb = {{k: torch.from_numpy(v) for k, v in np.load(d + "/moe_batch.npz").items()}}
    settings = TT.TrainSettings(opt=TO.AdamWConfig(**tts.OPT))
    for tag, mcfg in (("moe", tts.moe_config()), ("moe_dense", tts.moe_config(ep=False))):
        step, _ = TT.make_train_step(mcfg, mesh, mb, settings)
        params, opt = TT.init_sharded(mcfg, mesh, 0, device="cpu")
        res[tag + "_experts_local"] = np.asarray(params.params["blocks.0.ffn.wi"].shape)
        for i in range(2):
            params, opt, m = step(params, opt, mb)
            for k in ("loss", "drop_frac", "lb_loss", "z_loss", "grad_norm"):
                res["%s_%s_%d" % (tag, k, i)] = m[k].numpy()

    # eight steps of the reference's scenario: the loss falls
    settings = TT.TrainSettings(opt=TO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    step, _ = TT.make_train_step(cfg, mesh, synth_batch(dc, 0), settings)
    params, opt = TT.init_sharded(cfg, mesh, 0, device="cpu")
    losses = []
    for i in range(8):
        params, opt, m = step(params, opt, synth_batch(dc, i))
        losses.append(float(m["loss"]))
    res["losses"] = np.asarray(losses)

    # elastic reshard: the reference's checkpoint onto three meshes
    cfg7 = tts.smoke_config("qwen2.5-3b")
    meta = M.param_specs(cfg7)
    want7 = dict(np.load(d + "/elastic.npz"))
    blank = lambda node: ({{k: blank(v) for k, v in node.items()}} if isinstance(node, dict)
                          else [blank(v) for v in node] if isinstance(node, list)
                          else torch.empty(0))
    template = {{"params": blank(shd.reference_shapes(meta, cfg7))}}
    bad = 0
    for shape in ((2, 2), (1, 4), (4, 1)):
        mb = make_host_mesh(*shape, device="cpu")
        specs = shd.param_pspecs(cfg7, meta, mb)
        out, manifest = restore_checkpoint(d + "/ck_ref", template,
                                           shardings={{"params": shd.to_named(specs, mb)}})
        assert manifest["step"] == 3
        flat_out, flat_spec = tts.flat_tree(out["params"]), tts.flat_spec(specs)
        for k, v in flat_out.items():
            w = want7[k][shd.local_slices(flat_spec[k], want7[k].shape, mb)]
            bad += int(not (v.dtype == w.dtype and np.array_equal(v, w)))
        res["elastic_n_%dx%d" % shape] = np.asarray(len(flat_out))
        if shape == (2, 2):
            full = shd.gather_tree({{"params": out["params"]}}, {{"params": specs}},
                                   {{"params": shd.reference_shapes(meta, cfg7)}}, mb)
            if rank == 0:
                save_checkpoint(d + "/ck_port", 5, full)
            dist.barrier()
    res["elastic_bad"] = np.asarray(bad)
    np.savez(d + "/out." + str(rank) + ".npz", **res)
finally:
    dist.destroy_process_group()
print("RANK_DONE", rank)
"""


def flat_spec(specs, prefix=""):
    """A spec tree (``sharding.Spec`` leaves) as {"a/b/0/c": spec}."""
    from repro_torch.dist.sharding import Spec
    if isinstance(specs, Spec):
        return {prefix[:-1]: specs}
    items = specs.items() if isinstance(specs, dict) else enumerate(specs)
    return {k2: v2 for k, v in items for k2, v2 in flat_spec(v, f"{prefix}{k}/").items()}


def _write_inputs(d: Path) -> None:
    """The JAX init and the batches the ranks read, and the reference's
    elastic-reshard checkpoint (``scenario_elastic_reshard``'s weights)."""
    jcfg, _ = configs()
    init = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(1)))
    np.savez(d / "init.npz", **flat_tree(init))
    np.savez(d / "batch.npz", **batch())
    rng = np.random.default_rng(4)
    np.savez(d / "moe_batch.npz", **{k: rng.integers(0, 512, (B, S)).astype(np.int32)
                                     for k in ("tokens", "labels")})
    p7 = JM.init_params(jax_smoke_config("qwen2.5-3b"), jax.random.PRNGKey(7))
    np.savez(d / "elastic.npz", **flat_tree(jax.tree.map(np.asarray, p7)))
    jckpt.save_checkpoint(str(d / "ck_ref"), 3, {"params": p7})


def _write_jax_step(d: Path) -> None:
    """The JAX package's one-device step from the same weights and batch:
    the params after it, the gradients and the first moments after it by
    path (``jax_p2``/``jax_grads``/``jax_mu.npz``), its metrics
    (``jax_metrics.json``)."""
    jcfg, _ = configs()
    bt = {k: jnp.asarray(v) for k, v in batch().items()}
    settings = JT.TrainSettings(opt=JO.AdamWConfig(**OPT))
    jparams = jax.tree.map(jnp.asarray, unflat_tree(dict(np.load(d / "init.npz"))))
    _, jgrads = jax.value_and_grad(JT.loss_and_aux, has_aux=True)(jparams, jcfg, bt, settings)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    step, _ = JT.make_train_step(jcfg, mesh, {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                                              for k, v in bt.items()}, settings)
    p2, opt2, m = jax.jit(step)(jparams, JO.init_opt_state(jparams), bt)
    for name, tree in (("p2", p2), ("grads", jgrads), ("mu", opt2.mu)):
        np.savez(d / f"jax_{name}.npz", **flat_tree(jax.tree.map(np.asarray, tree)))
    (d / "jax_metrics.json").write_text(json.dumps({k: float(v) for k, v in m.items()}))


@pytest.fixture(scope="module")
def shared(tmp_path_factory, cleared_jax_caches):
    """The directory that the JAX inputs, the four ranks' results and the
    JAX step fill, each once in a test run, whatever the number of workers
    (``tests/_once.py``): the inputs first; then the worker that takes the
    ranks starts them, and the JAX step runs while they do."""
    root = shared_root(tmp_path_factory)
    d = root / "train_sharded"
    d.mkdir(exist_ok=True)
    code = textwrap.dedent(_RANK.format(tests=str(ROOT / "tests"), world=WORLD))
    once(root, "tsh_inputs", lambda: _write_inputs(d))
    with claim(root, "tsh_ranks") as mine:
        procs = start_ranks(code, d) if mine else None
        try:
            once(root, "tsh_jax_step", lambda: _write_jax_step(d))
        finally:
            if procs is not None:
                finish_ranks(procs, d)
    once(root, "tsh_ranks", lambda: finish_ranks(start_ranks(code, d), d))
    jax.clear_caches()
    return d


@pytest.fixture(scope="module")
def jax_init(shared):
    return unflat_tree(dict(np.load(shared / "init.npz")))


@pytest.fixture(scope="module")
def gloo(shared):
    return dict(ranks=[dict(np.load(shared / f"out.{r}.npz")) for r in range(WORLD)],
                dir=shared, p7=unflat_tree(dict(np.load(shared / "elastic.npz"))))


@pytest.fixture(scope="module")
def jax_step(shared):
    """``_write_jax_step``'s results: (params after, metrics, grads, first
    moments after; by path)."""
    load = lambda name: dict(np.load(shared / f"jax_{name}.npz"))
    return (load("p2"), json.loads((shared / "jax_metrics.json").read_text()), load("grads"),
            load("mu"))


def _params_close(got: dict, tag: str, jp2: dict, jgrads: dict, gnorm: float, lr: float):
    clip = min(1.0, 1.0 / gnorm)
    for k, want in jp2.items():
        g = got[f"{tag}:{k}"]
        err = np.abs(g.astype(np.float32) - want.astype(np.float32))
        sharp = np.abs(jgrads[k].astype(np.float32)) * clip > 1e-6
        assert float(err[sharp].max(initial=0.0)) <= 1e-6, f"{tag} {k}"
        assert float(err.max()) <= 2 * lr, f"{tag} {k}"


@pytest.mark.parametrize("tag", ["step", "sp"])
def test_sharded_step_matches_jax_one_device(gloo, jax_step, tag):
    """One step on the (2, 2) mesh, with and without sequence
    parallelism: loss, grad norm, lr and the parameters after it, against
    the JAX package's one-device step; every rank reports the same."""
    jp2, jm, jgrads, _ = jax_step
    for r, out in enumerate(gloo["ranks"]):
        for k in ("loss", "grad_norm"):
            want = float(jm[k])
            assert abs(float(out[f"{tag}_{k}"]) - want) <= 1e-5 * abs(want), (r, k)
        assert float(out[f"{tag}_lr"]) == float(jm["lr"])
        _params_close(out, tag, jp2, jgrads, float(jm["grad_norm"]), float(jm["lr"]))
    assert bool(gloo["ranks"][0]["sp_used_sp"]) and not bool(gloo["ranks"][0]["step_used_sp"])


def test_sequence_parallel_equals_plain_tensor_parallel(gloo):
    """Megatron SP against the all-reduce form on the same mesh: the loss
    and grad norm within 1e-6 relative, every parameter within 1e-6."""
    out = gloo["ranks"][0]
    for k in ("loss", "grad_norm"):
        a, b = float(out[f"step_{k}"]), float(out[f"sp_{k}"])
        assert abs(a - b) <= 1e-6 * abs(a), k
    for k in out:
        if k.startswith("step:"):
            np.testing.assert_allclose(out["sp:" + k[5:]], out[k], rtol=0, atol=1e-6)


def test_local_shards_are_the_tables_slices(gloo):
    """After a step every rank's parameters and ZeRO-1 moments are bitwise
    the table's slices of the gathered state (replicas stayed equal), the
    runtime's first shards are ``shard_tree``'s of the whole initial tree,
    and the mesh really split some leaves."""
    for out in gloo["ranks"]:
        assert int(out["bad_shards"]) == 0
        assert int(out["n_sharded"]) > 0


def test_sharded_moments_match_jax_one_device(gloo, jax_step):
    """The first moments after the step, gathered from the ZeRO-1 shards,
    against the JAX step's: within 2e-4 of each leaf's largest value."""
    jmu = jax_step[3]
    for out in gloo["ranks"]:
        for k, want in jmu.items():
            got = out["mu:" + k]
            scale = max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(got - want).max()) <= 2e-4 * scale, k


def test_int8_hook_on_shards_is_the_whole_hook(gloo):
    """The int8 hook on each rank's shards, the amax shared over the world,
    is bitwise the hook on the whole gradient: outputs and residuals."""
    for out in gloo["ranks"]:
        assert int(out["hook_bad"]) == 0


def test_int8_step_matches_one_device_port(gloo, jax_init):
    """One int8 step with error feedback on the mesh against the one-device
    port's: loss and grad norm within 1e-5 relative, parameters within 2 lr,
    residuals within one quantisation step (the leaf's amax / 127) of the
    one-device residuals, since a value at a rounding boundary may round
    either way."""
    from repro_torch.models.convert import params_to_tree, to_reference_tree
    _, cfg = configs()
    params = M.trainable(params_from_jax(jax_init, cfg, device="cpu"))
    settings = TT.TrainSettings(opt=TO.AdamWConfig(**OPT), grad_compression="int8",
                                error_feedback=True)
    bt = {k: torch.from_numpy(v) for k, v in batch().items()}
    layout = reference_layout(params, cfg)
    _, _, grads = TT.loss_and_grads(params, cfg, bt, settings)
    amax = flat_tree(to_reference_tree({k: g.abs() for k, g in grads.items()}, layout))
    opt = TO.init_opt_state(params)
    ef = init_ef_state({k: p.detach() for k, p in params.named_parameters()})
    _, _, ef, m = TT.make_train_step(cfg, settings=settings)(params, opt, ef, bt)
    want_p = flat_tree(params_to_tree(params, cfg))
    want_ef = flat_tree(to_reference_tree(ef, layout))
    lr = float(m["lr"])
    for out in gloo["ranks"]:
        for k in ("loss", "grad_norm"):
            assert abs(float(out[f"int8_{k}"]) - float(m[k])) <= 1e-5 * abs(float(m[k])), k
        for k, w in want_p.items():
            assert float(np.abs(out[f"int8:{k}"] - w).max()) <= 2 * lr, k
        for k, w in want_ef.items():
            step = float(amax[k].max()) / 127 * (1 + 1e-5)
            assert float(np.abs(out[f"int8_ef:{k}"] - w).max()) <= step, k


def test_eight_sharded_steps_learn(gloo):
    """``scenario_train_step_sharded``'s run on the port's mesh: eight
    steps, finite losses, the last below the first, equal on every rank."""
    losses = gloo["ranks"][0]["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    for out in gloo["ranks"][1:]:
        np.testing.assert_array_equal(out["losses"], losses)


def test_reference_checkpoint_reshards_onto_port_meshes(gloo):
    """``scenario_elastic_reshard``'s checkpoint (written by the JAX
    package) restores onto (2, 2), (1, 4) and (4, 1) meshes of the port with
    every rank's local shards bitwise the table's slices."""
    n = len(flat_tree(jax.tree.map(np.asarray, gloo["p7"])))
    for out in gloo["ranks"]:
        assert int(out["elastic_bad"]) == 0
        for shape in ("2x2", "1x4", "4x1"):
            assert int(out[f"elastic_n_{shape}"]) == n


def test_port_mesh_checkpoint_restores_in_reference(gloo):
    """A checkpoint that the port wrote from its (2, 2) mesh restores into
    ``repro.dist.checkpoint`` bitwise."""
    p7 = gloo["p7"]
    out, manifest = jckpt.restore_checkpoint(str(gloo["dir"] / "ck_port"), {"params": p7})
    assert manifest["step"] == 5
    for a, b in zip(jax.tree.leaves(p7), jax.tree.leaves(out["params"])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_moe_block_trains_expert_parallel(gloo):
    """qwen2-moe's smoke model on the (2, 2) mesh: each data rank holds
    half the experts, each model rank half their hidden dim; dropless, the
    first step's loss is the one-device port's within 1e-5 relative (the
    load-balance loss is the reference EP's mean over the data ranks, not
    the global one) and the second step's loss is lower."""
    mcfg = moe_config()
    rng = np.random.default_rng(4)
    mb = {k: torch.from_numpy(rng.integers(0, 512, (B, S)).astype(np.int32))
          for k in ("tokens", "labels")}
    params, opt = TT.init_all(mcfg, 0, device="cpu")
    _, _, m = TT.make_train_step(mcfg, settings=TT.TrainSettings(opt=TO.AdamWConfig(**OPT)))(
        params, opt, mb)
    E, D, F = mcfg.padded_experts, mcfg.d_model, mcfg.moe_d_ff
    for out in gloo["ranks"]:
        assert tuple(out["moe_experts_local"]) == (E // 2, D, F // 2)
        assert abs(float(out["moe_loss_0"]) - float(m["loss"])) <= 1e-5 * float(m["loss"])
        assert float(out["moe_drop_frac_0"]) == 0.0 == float(m["drop_frac"])
        assert np.isfinite(out["moe_lb_loss_0"]) and float(out["moe_grad_norm_0"]) > 0
        assert float(out["moe_loss_1"]) < float(out["moe_loss_0"])


def test_moe_block_trains_dense_dispatch_over_data(gloo):
    """qwen2-moe's smoke model without expert parallelism on the (2, 2)
    mesh: every expert gathered, their hidden dim split, each data rank's
    tokens placed in the whole batch's dispatch at its capacity (1.25,
    which drops some): the first step's loss, load-balance and z losses
    within 1e-5 relative of the one-device port's, the same dropped
    share."""
    mcfg = moe_config(ep=False)
    rng = np.random.default_rng(4)
    mb = {k: torch.from_numpy(rng.integers(0, 512, (B, S)).astype(np.int32))
          for k in ("tokens", "labels")}
    params, opt = TT.init_all(mcfg, 0, device="cpu")
    _, _, m = TT.make_train_step(mcfg, settings=TT.TrainSettings(opt=TO.AdamWConfig(**OPT)))(
        params, opt, mb)
    E, D, F = mcfg.padded_experts, mcfg.d_model, mcfg.moe_d_ff
    assert float(m["drop_frac"]) > 0
    for out in gloo["ranks"]:
        assert tuple(out["moe_dense_experts_local"]) == (E, D, F // 2)
        for k in ("loss", "lb_loss", "z_loss"):
            w = float(m[k])
            assert abs(float(out[f"moe_dense_{k}_0"]) - w) <= 1e-5 * abs(w), k
        assert float(out["moe_dense_drop_frac_0"]) == float(m["drop_frac"])
        assert float(out["moe_dense_loss_1"]) < float(out["moe_dense_loss_0"])
