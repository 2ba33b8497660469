"""The port's int8 gradient compression against the JAX package.

``compressed_mean_hook`` is bitwise to the reference for the same
gradients, with and without error feedback, over ten steps (one f32 scale
a leaf, ``max(amax, tiny) / 127``, rounding half to even in both).
``compressed_psum_mean`` runs over gloo at world size 4 (four rank
subprocesses meeting through a ``file://`` init, as the forest's
``group=`` fronts are checked) against the reference's shard_map form on
4 host devices (one subprocess, ``XLA_FLAGS``): the mean bitwise, the
residual within one rounding (XLA fuses it into a multiply-add).  Then the port's
train step with int8 and error feedback against its uncompressed
trajectory, in the band of the reference's
``test_error_feedback.py::test_train_step_ef_convergence_parity``.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dist import compression as JC  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, synth_batch  # noqa: E402
from repro_torch.dist import compression as TC  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.train_step import TrainSettings, init_all, make_train_step  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4


def _grads(rng, step):
    """A gradient tree: stacked f32 leaves of very different scales, a bf16
    leaf, an all-zero leaf (the scale's ``tiny`` floor) and an int32 leaf
    that passes through."""
    return {"blocks": [{"w": rng.normal(size=(3, 16, 8)).astype(np.float32) * 10.0 ** (step % 3),
                        "b": rng.normal(size=(3, 8)).astype(np.float32) * 1e-4}],
            "embed": rng.normal(size=(40, 8)).astype(np.float32),
            "half": np.asarray(jnp.asarray(rng.normal(size=(5, 7)), jnp.bfloat16)),
            "zero": np.zeros((4,), np.float32),
            "count": np.arange(6, dtype=np.int32)}


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _assert_bitwise(got, want):
    gl = jax.tree_util.tree_leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        w = w.view(np.int16) if w.dtype.name == "bfloat16" else w
        assert _bits(g).dtype == w.dtype and np.array_equal(_bits(g), w)


@pytest.mark.parametrize("ef", [False, True])
def test_hook_is_bitwise_to_jax_over_ten_steps(ef):
    rng = np.random.default_rng(7)
    j_ef = t_ef = None
    if ef:
        g0 = _grads(rng, 0)
        j_ef = JC.init_ef_state(jax.tree.map(jnp.asarray, g0))
        t_ef = TC.init_ef_state(jax.tree.map(_to_torch, g0))
        _assert_bitwise(t_ef, j_ef)
    for step in range(10):
        g = _grads(rng, step)
        want = JC.compressed_mean_hook(jax.tree.map(jnp.asarray, g), ef=j_ef)
        got = TC.compressed_mean_hook(jax.tree.map(_to_torch, g), ef=t_ef)
        if ef:
            (want, j_ef), (got, t_ef) = want, got
            _assert_bitwise(t_ef, j_ef)
        _assert_bitwise(got, want)
    assert TC.compressed_mean_hook({"a": torch.ones(2)}, mode="none")["a"].sum() == 2


def test_grouped_hook_equals_the_stacked_leafs():
    """The train step's form: the per-layer slices of one stacked leaf share
    the leaf's scale, so the outputs and residuals are the stacked hook's."""
    rng = np.random.default_rng(9)
    stacked = {"w": torch.from_numpy(rng.normal(size=(4, 6, 5)).astype(np.float32)),
               "e": torch.from_numpy(rng.normal(size=(9, 5)).astype(np.float32) * 3)}
    flat = {f"w{i}": stacked["w"][i].clone() for i in range(4)} | {"e": stacked["e"]}
    groups = [[f"w{i}" for i in range(4)], ["e"]]
    ef = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32) * 0.01)
          for k, v in flat.items()}
    ef_stacked = {"w": torch.stack([ef[f"w{i}"] for i in range(4)]), "e": ef["e"]}
    got, got_ef = TC.compressed_mean_hook(flat, groups=groups, ef=ef)
    want, want_ef = TC.compressed_mean_hook(stacked, ef=ef_stacked)
    for i in range(4):
        assert torch.equal(got[f"w{i}"], want["w"][i])
        assert torch.equal(got_ef[f"w{i}"], want_ef["w"][i])
    assert torch.equal(got["e"], want["e"]) and torch.equal(got_ef["e"], want_ef["e"])


def _psum_inputs():
    rng = np.random.default_rng(11)
    return {"g": rng.normal(size=(WORLD, 64, 12)).astype(np.float32),
            "h": (rng.normal(size=(WORLD, 33)) * np.array([1e-3, 1, 10, 100])[:, None]
                  ).astype(np.float32),
            "e_g": rng.normal(size=(WORLD, 64, 12)).astype(np.float32) * 0.02,
            "e_h": rng.normal(size=(WORLD, 33)).astype(np.float32) * 0.5}


_JAX = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={world}"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.dist.compression import compressed_psum_mean
from repro.dist.sharding import shard_map, use_mesh

inp = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh(({world},), ("data",))
spec = {{"g": P("data"), "h": P("data")}}

def run(with_ef):
    def body(tree, ef):
        mean, err = compressed_psum_mean(tree, "data", ef=ef if with_ef else None)
        return mean, err
    f = shard_map(body, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec),
                  check_rep=False)
    tree = {{"g": jnp.asarray(inp["g"]), "h": jnp.asarray(inp["h"])}}
    ef = {{"g": jnp.asarray(inp["e_g"]), "h": jnp.asarray(inp["e_h"])}}
    with use_mesh(mesh):
        return jax.jit(f)(tree, ef)

out = {{}}
for with_ef in (False, True):
    mean, err = run(with_ef)
    for k in ("g", "h"):
        out[f"mean_{{k}}_{{int(with_ef)}}"] = np.asarray(mean[k])
        out[f"err_{{k}}_{{int(with_ef)}}"] = np.asarray(err[k])
np.savez(sys.argv[2], **out)
print("DONE")
"""

_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.dist.compression import compressed_psum_mean

rank, init, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size={world})
try:
    x = dict(np.load(inp))
    res = {{}}
    tree = {{k: torch.from_numpy(x[k][rank:rank + 1].copy()) for k in ("g", "h")}}
    ef = {{k: torch.from_numpy(x["e_" + k][rank:rank + 1].copy()) for k in ("g", "h")}}
    for with_ef in (False, True):
        mean, err = compressed_psum_mean(tree, group=dist.group.WORLD,
                                         ef=ef if with_ef else None)
        for k in ("g", "h"):
            res[f"mean_{{k}}_{{int(with_ef)}}"] = mean[k].numpy()
            res[f"err_{{k}}_{{int(with_ef)}}"] = err[k].numpy()
    np.savez(out + "." + str(rank) + ".npz", **res)
finally:
    dist.destroy_process_group()
print("RANK_DONE", rank)
"""


def test_psum_mean_over_gloo_is_bitwise_to_jax(tmp_path):
    np.savez(tmp_path / "in.npz", **_psum_inputs())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX.format(world=WORLD)),
         str(tmp_path / "in.npz"), str(tmp_path / "jax.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    init = f"file://{tmp_path / 'rendezvous'}"
    ranks = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(_RANK.format(world=WORLD)),
                               str(r), init, str(tmp_path / "in.npz"), str(tmp_path / "out")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    procs = [jax_proc] + ranks
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert jax_proc.returncode == 0 and "DONE" in outs[0][0], outs[0][1][-3000:]
    for r, (p, (so, se)) in enumerate(zip(ranks, outs[1:])):
        assert p.returncode == 0 and f"RANK_DONE {r}" in so, se[-3000:]
    want = dict(np.load(tmp_path / "jax.npz"))
    x = _psum_inputs()
    for r in range(WORLD):
        got = dict(np.load(tmp_path / f"out.{r}.npz"))
        assert set(got) == set(want)
        for k, v in got.items():
            if k.startswith("mean"):
                assert np.array_equal(v, want[k][r:r + 1]), (r, k)
            else:
                # the residual g - q * scale: XLA's jitted loop fuses it into
                # one multiply-add, torch rounds the product first, so it is
                # held within one rounding of the largest |g + e|
                name, ef = k.split("_")[1:]
                gf = x[name][r] + (x["e_" + name][r] if ef == "1" else 0)
                tol = np.spacing(np.float32(np.abs(gf).max()))
                assert np.abs(v - want[k][r:r + 1]).max() <= tol, (r, k)
    # the mean is the same on every rank, within one quantisation step of
    # the true mean
    scale = np.abs(x["g"]).max() / 127
    assert np.abs(want["mean_g_0"][0] - x["g"].mean(0)).max() <= scale


def test_train_step_int8_error_feedback_tracks_uncompressed():
    """The reference's smoke parity, on the port: int8 + EF tracks the
    uncompressed loss within 0.15 x the first loss over 10 steps, both
    descend, and the EF state carries residuals."""
    cfg = dataclasses.replace(smoke_config("qwen2.5-3b"), n_layers=1, block_pattern=("attn",))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    opt = AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=40)

    def run(settings):
        step_fn = make_train_step(cfg, settings=settings)
        state = init_all(cfg, 0, device="cpu", error_feedback=settings.error_feedback)
        losses = []
        for s in range(10):
            batch = {k: torch.from_numpy(v) for k, v in synth_batch(dc, s).items()}
            if settings.error_feedback:
                params, o, ef, m = step_fn(*state, batch)
                state = (params, o, ef)
            else:
                params, o, m = step_fn(*state, batch)
                state = (params, o)
            losses.append(float(m["loss"]))
        return losses, state

    base, _ = run(TrainSettings(opt=opt))
    efl, (_, _, ef) = run(TrainSettings(opt=opt, grad_compression="int8", error_feedback=True))
    assert np.isfinite(base).all() and np.isfinite(efl).all()
    assert base[-1] < base[0] and efl[-1] < efl[0], (base, efl)
    assert abs(efl[-1] - base[-1]) < 0.15 * abs(base[0]), (base, efl)
    assert max(float(e.abs().max()) for e in ef.values()) > 0.0
    # int8 without EF changes the trajectory too (the hook is wired in)
    q8, _ = run(TrainSettings(opt=opt, grad_compression="int8"))
    assert q8 != base
