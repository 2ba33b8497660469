"""Expert-parallel MoE (``models/moe.py:moe_apply_ep``) over gloo at world
size 4 on the CPU, against the JAX package's ``moe_apply`` under
``moe_ep=True`` on a host mesh.

The JAX side runs in a subprocess with 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), on
``scenario_moe_ep_equivalence``'s config (grok-1-314b smoke with 8
experts, top-2), at that scenario's dropless capacity factor (64) and at
a tight one (1.0), on a (4, 2) mesh (four data ranks) and a (2, 2) mesh;
its weights, inputs and results come back as ``.npz``.  The port's four
ranks meet through a ``file://`` init: on a (4, 1) mesh each data rank
holds two experts whole, on a (2, 2) mesh four experts with half their
hidden dim each (the experts' FFN tensor-parallel over 'model').

Tolerances: y within 2e-4 (the scenario's), lb_loss and z_loss within
1e-5 relative, drop_frac equal (a mean of multiples of 1/64).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the rank subprocesses also stop at their own communicate() timeouts
pytestmark = pytest.mark.timeout(600)

from _gloo_ranks import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CASES = {"dropless": 64.0, "tight": 1.0}
MESHES = {"4x2": (4, 2), "2x2": (2, 2)}

_JAX = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.all_archs import smoke_config
from repro.dist.sharding import use_mesh
from repro.models import moe as moe_mod
d = sys.argv[1]
out = {}
for case, cf in %r.items():
    cfg = dataclasses.replace(smoke_config("grok-1-314b"), n_experts=8, experts_per_token=2,
                              expert_pad_to=0, capacity_factor=cf)
    p = moe_mod.moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 16, cfg.d_model))
    for k in ("router", "wi", "wg", "wo"):
        out[f"{case}:p:{k}"] = np.asarray(p[k])
    out[f"{case}:x"] = np.asarray(x)
    y, aux = moe_mod.moe_apply(p, cfg, x)
    out[f"{case}:dense:y"] = np.asarray(y)
    for k, v in aux.items():
        out[f"{case}:dense:{k}"] = np.asarray(v)
    cfg_ep = dataclasses.replace(cfg, moe_ep=True)
    for name, shape in %r.items():
        mesh = jax.make_mesh(shape, ("data", "model"))
        with use_mesh(mesh):
            y, aux = jax.jit(lambda p, x: moe_mod.moe_apply(p, cfg_ep, x))(p, x)
        out[f"{case}:{name}:y"] = np.asarray(y)
        for k, v in aux.items():
            out[f"{case}:{name}:{k}"] = np.asarray(v)
np.savez(d + "/jax.npz", **out)
print("JAX_DONE")
"""

_RANK = """
import dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs import smoke_config
from repro_torch.dist.sharding import use_mesh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as moe_mod
from types import SimpleNamespace

rank, init, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4)
try:
    ref = dict(np.load(d + "/jax.npz"))
    res = {{}}
    meshes = {{"4x2": make_host_mesh(4, 1, device="cpu"), "2x2": make_host_mesh(2, 2, device="cpu")}}
    for case, cf in {cases!r}.items():
        cfg = dataclasses.replace(smoke_config("grok-1-314b"), n_experts=8, experts_per_token=2,
                                  expert_pad_to=0, capacity_factor=cf, moe_ep=True)
        x = torch.from_numpy(ref[case + ":x"])
        for name, mesh in meshes.items():
            G, m = mesh.shape
            dr, mr = mesh.get_local_rank("data"), mesh.get_local_rank("model")
            E, F = cfg.padded_experts, ref[case + ":p:wi"].shape[-1]
            e = slice(dr * E // G, (dr + 1) * E // G)
            f = slice(mr * F // m, (mr + 1) * F // m)
            t = lambda k: torch.from_numpy(ref[case + ":p:" + k])
            p = SimpleNamespace(router=t("router"), wi=t("wi")[e, :, f], wg=t("wg")[e, :, f],
                                wo=t("wo")[e, f, :], shared=None)
            rows = slice(dr * 8 // G, (dr + 1) * 8 // G)
            y, aux = moe_mod.moe_apply_ep(p, cfg, x[rows], group=mesh.get_group("data"),
                                          model_group=mesh.get_group("model") if m > 1 else None)
            res[case + ":" + name + ":y"] = y.detach().numpy()
            for k, v in aux.items():
                res[case + ":" + name + ":" + k] = v.detach().numpy()
            # dense dispatch of the whole batch: every expert, the hidden dim split
            pd = SimpleNamespace(router=t("router"), wi=t("wi")[:, :, f], wg=t("wg")[:, :, f],
                                 wo=t("wo")[:, f, :], shared=None)
            yd, auxd = moe_mod.moe_apply(
                pd, dataclasses.replace(cfg, moe_ep=False), x[rows],
                data_group=mesh.get_group("data"),
                model_group=mesh.get_group("model") if m > 1 else None)
            res[case + ":" + name + ":dense_y"] = yd.detach().numpy()
            for k, v in auxd.items():
                res[case + ":" + name + ":dense_" + k] = v.detach().numpy()
            with use_mesh(mesh):           # the data group from the ambient mesh
                y2, _ = moe_mod.moe_apply_ep(
                    p, cfg, x[rows], model_group=mesh.get_group("model") if m > 1 else None)
            res[case + ":" + name + ":ambient_equal"] = np.asarray(torch.equal(y, y2))
    np.savez(d + "/out." + str(rank) + ".npz", **res)
finally:
    dist.destroy_process_group()
print("RANK_DONE", rank)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    p = subprocess.run([sys.executable, "-c", _JAX % (CASES, MESHES), str(d)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and "JAX_DONE" in p.stdout, p.stderr[-3000:]
    ranks = run_ranks(textwrap.dedent(_RANK.format(cases=CASES)), d)
    return dict(np.load(d / "jax.npz")), ranks


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_ep_matches_reference_ep(results, case, mesh):
    """Each data rank's rows of y, and the aux values on every rank,
    against the reference's EP form on the same mesh shape."""
    ref, ranks = results
    G = MESHES[mesh][0]
    for r, out in enumerate(ranks):
        dr = r // (4 // G)            # the mesh's rank order: data-major
        rows = slice(dr * 8 // G, (dr + 1) * 8 // G)
        np.testing.assert_allclose(out[f"{case}:{mesh}:y"], ref[f"{case}:{mesh}:y"][rows],
                                   rtol=2e-4, atol=2e-4)
        for k in ("lb_loss", "z_loss"):
            w = float(ref[f"{case}:{mesh}:{k}"])
            assert abs(float(out[f"{case}:{mesh}:{k}"]) - w) <= 1e-5 * abs(w), k
        assert float(out[f"{case}:{mesh}:drop_frac"]) == float(ref[f"{case}:{mesh}:drop_frac"])
        assert bool(out[f"{case}:{mesh}:ambient_equal"])      # group from use_mesh


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_dispatch_over_data_matches_reference_dense(results, case, mesh):
    """``moe_apply(data_group=)``: each rank's rows dispatched as part of
    the whole batch (global capacity, slots after the lower ranks') equal
    the reference's one-device ``moe_apply``: y within 2e-4, lb_loss and
    z_loss within 1e-5 relative, drop_frac equal."""
    ref, ranks = results
    G = MESHES[mesh][0]
    for r, out in enumerate(ranks):
        dr = r // (4 // G)
        rows = slice(dr * 8 // G, (dr + 1) * 8 // G)
        np.testing.assert_allclose(out[f"{case}:{mesh}:dense_y"], ref[f"{case}:dense:y"][rows],
                                   rtol=2e-4, atol=2e-4)
        for k in ("lb_loss", "z_loss"):
            w = float(ref[f"{case}:dense:{k}"])
            assert abs(float(out[f"{case}:{mesh}:dense_{k}"]) - w) <= 1e-5 * abs(w), k
        assert float(out[f"{case}:{mesh}:dense_drop_frac"]) == float(ref[f"{case}:dense:drop_frac"])


def test_tight_capacity_drops_as_ep_not_as_dense(results):
    """At capacity factor 1.0 each rank's own capacity drops a set that
    dense dispatch does not: the drop fractions differ, and the port's is
    the reference EP's; dropless, all three drop nothing."""
    ref, ranks = results
    for mesh in MESHES:
        assert float(ref[f"tight:{mesh}:drop_frac"]) != float(ref["tight:dense:drop_frac"])
        assert float(ranks[0][f"tight:{mesh}:drop_frac"]) == float(ref[f"tight:{mesh}:drop_frac"])
        assert float(ranks[0][f"dropless:{mesh}:drop_frac"]) == 0.0
    assert float(ref["dropless:dense:drop_frac"]) == 0.0
    assert float(ref["tight:dense:drop_frac"]) > 0.0


def test_ep_falls_back_where_the_reference_does():
    """No group, or a batch or expert count the data ranks do not divide:
    ``moe_apply_ep`` is ``moe_apply`` (the reference's test at
    ``moe.py:66``)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import moe as moe_mod
    cfg = dataclasses.replace(smoke_config("grok-1-314b"), n_experts=8, experts_per_token=2,
                              expert_pad_to=0, moe_ep=True)
    p = moe_mod.MoE.init(cfg, torch.float32, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    x = torch.randn(2, 4, cfg.d_model, generator=torch.Generator().manual_seed(1))
    y, aux = moe_mod.moe_apply_ep(p, cfg, x)
    y2, aux2 = moe_mod.moe_apply(p, cfg, x)
    assert torch.equal(y, y2) and all(torch.equal(aux[k], aux2[k]) for k in aux)
    assert not moe_mod.ep_applies(cfg, 8, None)
