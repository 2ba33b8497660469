"""The tensor-parallel runtime of the Mamba, xLSTM, encoder-decoder and
vision-stub models over gloo at world size 4 on the CPU, against the JAX
package's one-device train step and the port's one-device serving.

Four ranks start once in a test run, not once per pytest-xdist worker
(``tests/_once.py``; ``tests/_gloo_ranks.py``, the code in
``tests/_sharded_families.py``), and run every case there: the smoke
configs of jamba-v0.1-52b, xlstm-1.3b and internvl2-1b on a (2, 2)
{data, model} mesh, whisper-tiny on (2, 2), an xlstm with 2 heads on a
(1, 4) mesh (each head spans two ranks) and a whisper with 6 heads on
(1, 4) (the table replicates ``wq``), with weights from the JAX init
carried as an ``.npz`` of the reference's tree; then ``launch/serve --mesh
host --knn`` and ``launch/train --mesh host`` of each of the four
families.  The JAX inits and steps are computed here, once in a test run
beside the ranks; the port's one-device runs in a module fixture.

Tolerances, each stated where it is used: the loss and the grad norm
within 1e-5 relative of the JAX step's (sums over ranks change the order
of reduction); a parameter after the step within 1e-6 where the clipped
gradient is above 1e-6 and within 2 lr elsewhere (``test_torch_train.py``'s
rule); prefill and decode logits within 1e-5 of the largest |logit| of the
port's one-device run; the local shards and both checkpoints bitwise;
served tokens bitwise the one-device ``launch/serve``'s; the trainer's loss
within 1e-5 relative of its one-device run's.
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
pytestmark = pytest.mark.timeout(900)

import _sharded_families as F  # noqa: E402
from _gloo_ranks import WORLD, finish_ranks, start_ranks  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)
from _once import claim, once, shared_root, worker_offset  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)
from repro.configs.all_archs import smoke_config as jax_smoke_config  # noqa: E402
from repro.dist import checkpoint as jckpt  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import train_step as JT  # noqa: E402
from repro_torch.configs import list_archs, smoke_config  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NAMES = list(F.CASES)
ARCHS = list_archs()
TRAIN_TAGS = [(n, "step") for n in NAMES] + [("internvl2", "sp")]


def jax_config(name: str):
    c = F.CASES[name]
    return dataclasses.replace(jax_smoke_config(c["arch"]), **c["over"])


RANK_CODE = textwrap.dedent(f"""
    import sys
    sys.path.insert(0, {str(ROOT / "tests")!r})
    import _sharded_families
    _sharded_families.run_rank(int(sys.argv[1]), sys.argv[2], sys.argv[3])
""")


def _write_init(d: Path, n: str) -> None:
    """The JAX init of case ``n``, as ``init_<case>.npz`` and as the
    reference's checkpoint of it."""
    tree = jax.tree.map(np.asarray, JM.init_params(jax_config(n), jax.random.PRNGKey(1)))
    np.savez(d / f"init_{n}.npz", **F.flat_tree(tree))
    jckpt.save_checkpoint(str(d / f"ck_ref_{n}"), 2, {"params": tree})


def _write_jax_step(d: Path, n: str) -> None:
    """The JAX package's one-device step of case ``n`` from the same
    weights and batch: the params after it by path (``step_<case>.npz``),
    its metrics (``metrics_<case>.json``) and the clipped gradients by path
    (``clipped_<case>.npz``).  The step's first moments from zero are (1 -
    b1) times the clipped gradients, which gives them without a second
    program."""
    opt = JO.AdamWConfig(**F.OPT)
    bt = {k: jnp.asarray(v) for k, v in F.batch(smoke_config_of(n), 3).items()}
    jp = jax.tree.map(jnp.asarray, F.unflat_tree(dict(np.load(d / f"init_{n}.npz"))))
    step, _ = JT.make_train_step(jax_config(n), jax.make_mesh((1, 1), ("data", "model")),
                                 {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                                  for k, v in bt.items()}, JT.TrainSettings(opt=opt))
    p2, opt2, m = jax.jit(step)(jp, JO.init_opt_state(jp), bt)
    np.savez(d / f"step_{n}.npz", **F.flat_tree(jax.tree.map(np.asarray, p2)))
    np.savez(d / f"clipped_{n}.npz", **F.flat_tree(
        jax.tree.map(lambda mu: np.asarray(mu) / (1 - opt.b1), opt2.mu)))
    (d / f"metrics_{n}.json").write_text(json.dumps({k: float(v) for k, v in m.items()}))


@pytest.fixture(scope="module")
def shared(tmp_path_factory, cleared_jax_caches):
    """The directory that the JAX inits, the four ranks' results (their
    ``out.<rank>.npz`` and mesh checkpoints) and the JAX steps fill, each
    once in a test run, whatever the number of workers
    (``tests/_once.py``): every worker takes the inits of the cases nobody
    has done, each from its own offset; then the worker that takes the
    ranks starts them, and every worker takes the JAX steps the same way
    while they run."""
    root = shared_root(tmp_path_factory)
    d = root / "sharded_families"
    d.mkdir(exist_ok=True)
    k0 = worker_offset(len(NAMES))
    mine_first = NAMES[k0:] + NAMES[:k0]
    for n in mine_first:
        once(root, f"sf_init_{n}", lambda n=n: _write_init(d, n))

    def start():
        (d / "plan.json").write_text(json.dumps({"cases": NAMES}))
        return start_ranks(RANK_CODE, d)

    with claim(root, "sf_ranks") as mine:
        procs = start() if mine else None
        try:
            for n in mine_first:
                once(root, f"sf_step_{n}", lambda n=n: _write_jax_step(d, n))
        finally:
            if procs is not None:
                finish_ranks(procs, d, timeout=800)
    once(root, "sf_ranks", lambda: finish_ranks(start(), d, timeout=800))
    jax.clear_caches()
    return d


@pytest.fixture(scope="module")
def jax_inits(shared):
    return {n: F.unflat_tree(dict(np.load(shared / f"init_{n}.npz"))) for n in NAMES}


@pytest.fixture(scope="module")
def ranks(shared):
    return dict(out=[dict(np.load(shared / f"out.{r}.npz")) for r in range(WORLD)],
                dir=shared)


@pytest.fixture(scope="module")
def jax_steps(shared):
    """Each case's JAX step (``_write_jax_step``): (params after by path,
    metrics, the clipped gradients by path)."""
    return {n: (dict(np.load(shared / f"step_{n}.npz")),
                json.loads((shared / f"metrics_{n}.json").read_text()),
                dict(np.load(shared / f"clipped_{n}.npz"))) for n in NAMES}


def smoke_config_of(name: str):
    return F.config(name, smoke_config)


@pytest.fixture(scope="module")
def one_device(jax_inits):
    """The port's one-device prefill and decode logits of each case."""
    out = {}
    with torch.no_grad():
        for n in NAMES:
            cfg = smoke_config_of(n)
            params = params_from_jax(jax_inits[n], cfg, device="cpu")
            bt = {k: torch.from_numpy(v) for k, v in F.batch(cfg, 3).items()}
            out[f"{n}:prefill"] = M.forward(params, cfg, bt)[0].numpy()
            cache = M.init_cache(cfg, F.B, F.decode_len(cfg), device="cpu")
            if cfg.is_encdec:
                cache = encdec.encdec_prefill_cache(params, cfg, bt["frames"], cache)
            toks = torch.from_numpy(F.fed(cfg))
            for pos in range(F.DECODE_STEPS):
                logits, cache = M.decode_step(params, cfg, toks[:, pos], cache, pos)
                out[f"{n}:decode_{pos}"] = logits.numpy()
    return out


@pytest.mark.parametrize("name,tag", TRAIN_TAGS)
def test_sharded_step_matches_jax_one_device(ranks, jax_steps, name, tag):
    """One mesh step of each family (internvl2 with sequence parallelism
    too) against the JAX package's one-device step: loss and grad norm
    within 1e-5 relative on every rank, lr exactly, and the parameters
    after it by ``test_torch_train.py``'s rule (1e-6 where the clipped
    gradient is above 1e-6, 2 lr elsewhere)."""
    jp2, jm, jclipped = jax_steps[name]
    for r, out in enumerate(ranks["out"]):
        for k in ("loss", "grad_norm"):
            got = float(out[f"{name}:{tag}_{k}"])
            assert abs(got - jm[k]) <= 1e-5 * abs(jm[k]), (r, k, got, jm[k])
        assert float(out[f"{name}:{tag}_lr"]) == jm["lr"]
        assert bool(out[f"{name}:{tag}_used_sp"]) == (tag == "sp")
    out, lr = ranks["out"][0], jm["lr"]
    for k, want in jp2.items():
        err = np.abs(out[f"{name}:{tag}:{k}"].astype(np.float32) - want.astype(np.float32))
        sharp = np.abs(jclipped[k]) > 1e-6
        assert float(err[sharp].max(initial=0.0)) <= 1e-6, k
        assert float(err.max()) <= 2 * lr, k


@pytest.mark.parametrize("name", NAMES)
def test_local_shards_are_the_tables_slices(ranks, name):
    """Every rank's parameters after the step are bitwise the table's
    slices of the gathered state, its first shards ``shard_tree``'s of the
    whole initial tree, and the mesh split some leaves."""
    for out in ranks["out"]:
        assert int(out[f"{name}:bad_shards"]) == 0
        assert int(out[f"{name}:n_split"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_shards_as_the_table_says(ranks, arch):
    """Every arch of ``configs/all_archs.py`` at smoke size on the (2, 2)
    mesh: ``ShardedLM.from_model``'s shards are bitwise ``shard_tree``'s
    slices of the model's reference tree on every rank, and the model axis
    splits some of its weights."""
    for out in ranks["out"]:
        assert int(out[f"every:{arch}:bad"]) == 0
        assert int(out[f"every:{arch}:n_split"]) > 0


@pytest.mark.parametrize("name", NAMES)
def test_sharded_prefill_and_decode_match_one_device(ranks, one_device, name):
    """The mesh prefill's logits and two decode steps' (whisper: after the
    cross K/V filled from the frames on the mesh), gathered, within 1e-5 of
    the largest |logit| of the port's one-device run, on every rank."""
    for key in [f"{name}:prefill"] + [f"{name}:decode_{p}" for p in range(F.DECODE_STEPS)]:
        want = one_device[key]
        for out in ranks["out"]:
            got = out[key]
            assert got.shape == want.shape, key
            assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max()), key


def test_recurrent_and_kv_caches_split_as_the_table_says(ranks):
    """The caches each rank holds: jamba's Mamba state and window split
    along d_inner (128 channels, 64 a rank) and its attention cache along
    the sequence; the xLSTM's mLSTM state C along its first dh and sLSTM's
    along D; whisper's self and cross K/V along their sequences."""
    out = ranks["out"][0]
    jamba = json.loads(str(out["jamba:cache_shapes"]))
    assert jamba[0] == {"conv": [2, 3, 64], "h": [2, 64, 16]}
    assert jamba[4] == {"kv": [[2, 2, 4, 16], [2, 2, 4, 16]]}
    xl = json.loads(str(out["xlstm:cache_shapes"]))
    assert xl[0] == {"conv": [2, 3, 64], "C": [2, 4, 16, 32], "n": [2, 4, 16], "m": [2, 2]}
    assert xl[7] == {k: [2, 32] for k in "cnhm"}
    wide = json.loads(str(out["xlstm_tp_gt_h:cache_shapes"]))
    assert wide[0] == {"conv": [4, 3, 32], "C": [4, 2, 16, 64], "n": [4, 2, 16], "m": [4, 2]}
    wh = json.loads(str(out["whisper:cache_shapes"]))
    assert wh["self_k"] == [2, 2, 2, 32, 16] and wh["cross_k"] == [2, 2, 2, 12, 16]


@pytest.mark.parametrize("name", NAMES)
def test_mesh_checkpoint_restores_in_reference(ranks, jax_steps, name):
    """The checkpoint that the port wrote from its mesh (after one step)
    restores into ``repro.dist.checkpoint`` bitwise to the gathered
    parameters, and the reference's checkpoint of the initial tree restores
    onto the port's mesh with every rank's shards bitwise the table's
    slices."""
    jp2 = jax_steps[name][0]
    template = F.unflat_tree({k: np.zeros_like(v) for k, v in jp2.items()})
    out, manifest = jckpt.restore_checkpoint(str(ranks["dir"] / f"ck_port_{name}"),
                                             {"params": template})
    assert manifest["step"] == 1
    got = F.flat_tree(out["params"])
    mine = ranks["out"][0]
    assert set(got) == set(jp2)
    for k, v in got.items():
        want = mine[f"{name}:step:{k}"]
        assert v.dtype == want.dtype and np.array_equal(v, want), k
    for r in ranks["out"]:
        assert int(r[f"{name}:restore_bad"]) == 0
        assert int(r[f"{name}:restore_n"]) == len(jp2)


@pytest.mark.parametrize("arch", F.LAUNCH_ARCHS)
def test_launch_serve_mesh_host_tokens_equal_one_device(ranks, arch):
    """``launch/serve --mesh host --knn`` at world 4 gives the one-device
    run's tokens bitwise on every rank (whisper: the decoder alone, as in
    the reference)."""
    want = serve.main(F.SERVE + ["--arch", arch])
    for out in ranks["out"]:
        np.testing.assert_array_equal(out[f"serve:{arch}"], want)


@pytest.mark.parametrize("arch", F.LAUNCH_ARCHS)
def test_launch_train_mesh_host_matches_one_device(ranks, arch):
    """``launch/train --mesh host`` (the default) at world 4 trains each
    family to the one-device run's final loss, within 1e-5 relative, on
    every rank."""
    want = train.main(F.TRAIN + ["--arch", arch, "--mesh", "single"])
    for out in ranks["out"]:
        got = float(out[f"train:{arch}"])
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)
