"""Sharded serving over gloo at world size 4 on the CPU: ``launch/serve
--mesh host`` with the mesh store (ROADMAP item 13.4), the sharded decode
and prefill builders, against the port's one-device serving.

Four ranks meet through a ``file://`` init on a (2, 2) {data, model} mesh
(``tests/_gloo_ranks.py``).  ``--knn --knn-mutate --smoke`` serving must
give the one-device run's tokens bitwise, with the store's ``tree_digest``
equal on every rank (each applies the same window of mutations to its own
copy of the tree).  A prompt of 31 positions makes the KV cache 48 long,
which the model axis splits (the decode's log-sum-exp merge); the default
49 leaves it whole.  The long-context layout (``ServeSettings(seq_shard_
cache=True)``) at batch 1 folds the free data axis into the split: 16
positions over ('model', 'data'), 4 a rank, and a decode of all 16 reads
every rank's slice.  Logits: the sharded decode and prefill within 1e-5 of
the largest |logit| of the one-device ones (sums over ranks change the
order of reduction).
"""
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the rank subprocesses also stop at their own communicate() timeouts
pytestmark = pytest.mark.timeout(600)

from _gloo_ranks import WORLD, run_ranks  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)
from repro_torch.configs.all_archs import smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve.serve_step import make_prefill_step  # noqa: E402
from repro_torch.stream import tree_digest  # noqa: E402

ARGV = ["--smoke", "--knn", "--knn-mutate", "--device", "cpu"]
MOE_ARGV = ARGV + ["--arch", "qwen2-moe-a2.7b"]   # its tokens vary step to step
SPLIT = ["--prompt-len", "31"]
DECODE_POS = 6
LONG = 16
PREFILL = (4, 16)

def feed(batch: int, steps: int, vocab: int) -> np.ndarray:
    """The tokens the decode tests feed, one column a step: seeded random
    tokens rather than the model's own greedy ones, which a random smoke
    model repeats, so that every position's key and value differ and a
    position read from the wrong slice of the cache shows."""
    return np.random.default_rng(9).integers(0, vocab, (batch, steps)).astype(np.int32)


_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs.all_archs import smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.dist.collectives import all_gather
from repro_torch.dist.parallel import ShardedLM
from repro_torch.dist import sharding as shd
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.serve.serve_step import ServeSettings, make_decode_step, make_prefill_step
from repro_torch.stream import tree_digest

rank, init, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, {tests!r})
from test_torch_serve_sharded import feed
dist.init_process_group("gloo", init_method=init, rank=rank, world_size={world})
try:
    res = {{}}
    res["main_toks"] = serve.main({argv!r} + ["--mesh", "host"])
    res["moe_toks"] = serve.main({moe_argv!r} + ["--mesh", "host"])
    mesh = make_host_mesh(2, 2, device="cpu")
    args = serve.parser().parse_args({argv!r} + {split!r})
    cfg = smoke_config(args.arch)
    toks, store, _ = serve.serve_sharded(args, cfg, mesh)
    res["split_toks"] = toks
    res["digest"] = np.frombuffer(bytes.fromhex(tree_digest(store.stream.epochs.current()[1])),
                                  np.uint8)
    # the decode and prefill builders against one device
    params = ShardedLM.from_model(M.init_params(cfg, 0, device="cpu"), cfg, mesh)
    fn, sh = make_decode_step(cfg, mesh, ShapeSpec("d", 48, 4, "decode"))
    rows = shd.local_slices(sh["token"], (4,), mesh)[0]
    cache = params.init_cache(4, 48, sh["cache"])
    res["cache_split"] = np.asarray(cache[0]["kv"][0].shape[2])
    fed = torch.from_numpy(feed(4, {pos}, cfg.vocab_size))
    for pos in range({pos}):
        _, logits, cache = fn(params, fed[rows, pos], cache, pos)
        res["decode_logits_%d" % pos] = all_gather(logits, 0, mesh.get_group("data")).numpy()
    # the long-context layout: batch 1, the sequence over ('model', 'data')
    fn, sh = make_decode_step(cfg, mesh, ShapeSpec("d", {long}, 1, "decode"),
                              ServeSettings(seq_shard_cache=True))
    cache = params.init_cache(1, {long}, sh["cache"])
    res["long_spec"] = np.asarray(repr(sh["cache"][0]["kv"][0]))
    res["long_split"] = np.asarray(cache[0]["kv"][0].shape[2])
    fed = torch.from_numpy(feed(1, {long}, cfg.vocab_size))
    for pos in range({long}):
        _, logits, cache = fn(params, fed[:, pos], cache, pos)
        res["long_logits_%d" % pos] = logits.numpy()
    pf, psh = make_prefill_step(cfg, mesh, ShapeSpec("p", {prefill}[1], {prefill}[0], "prefill"))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, {prefill}).astype(np.int32))
    lg = pf(params, {{"tokens": tokens}})
    lg = all_gather(all_gather(lg, 2, mesh.get_group("model")), 0, mesh.get_group("data"))
    res["prefill_logits"] = lg.numpy()
    np.savez(d + "/out." + str(rank) + ".npz", **res)
finally:
    dist.destroy_process_group()
print("RANK_DONE", rank)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_sharded")
    code = textwrap.dedent(_RANK.format(world=WORLD, argv=ARGV, moe_argv=MOE_ARGV, split=SPLIT,
                                        pos=DECODE_POS, prefill=PREFILL, long=LONG,
                                        tests=str(Path(__file__).resolve().parent)))
    return run_ranks(code, d)


@pytest.fixture(scope="module")
def one_device():
    """The one-device serving runs: tokens and the store's digest."""
    out = {"main_toks": serve.main(ARGV), "moe_toks": serve.main(MOE_ARGV)}
    args = serve.parser().parse_args(ARGV + SPLIT)
    cfg = smoke_config(args.arch)
    params = M.init_params(cfg, 0, device="cpu")
    store = serve._build_store(args, cfg, "cpu")
    out["split_toks"], _ = serve.serve_loop(args, cfg, params, store)
    out["digest"] = tree_digest(store.stream.epochs.current()[1])
    return out


@pytest.mark.parametrize("run", ["main_toks", "split_toks", "moe_toks"])
def test_sharded_knn_serving_tokens_equal_one_device(ranks, one_device, run):
    """``--mesh host --knn --knn-mutate`` at world 4 gives the one-device
    tokens bitwise on every rank, with the cache whole (49 positions) and
    split over 'model' (48), and for qwen2-moe's smoke model (the MoE
    decode's experts gathered, their hidden dim split)."""
    for out in ranks:
        np.testing.assert_array_equal(out[run], one_device[run])
    assert int(ranks[0]["cache_split"]) == 48 // 2


def test_mesh_store_digest_equal_on_every_rank(ranks, one_device):
    """Every rank applied the same mutations to its own tree: equal
    ``tree_digest``s, and equal to the one-device store's."""
    want = np.frombuffer(bytes.fromhex(one_device["digest"]), np.uint8)
    for out in ranks:
        np.testing.assert_array_equal(out["digest"], want)


def test_sharded_decode_and_prefill_logits_match_one_device(ranks):
    """The mesh builders' decode (cache split over 'model') and prefill
    logits against one device's, within 1e-5 of the largest |logit|."""
    cfg = smoke_config("qwen2.5-3b")
    params = M.init_params(cfg, 0, device="cpu")
    cache = M.init_cache(cfg, 4, 48, device="cpu")
    fed = torch.from_numpy(feed(4, DECODE_POS, cfg.vocab_size))
    for pos in range(DECODE_POS):
        logits, cache = M.decode_step(params, cfg, fed[:, pos], cache, pos)
        want = logits.numpy()
        for out in ranks:
            got = out[f"decode_logits_{pos}"]
            assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max()), pos
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, PREFILL).astype(np.int32))
    want = make_prefill_step(cfg)(params, {"tokens": tokens}).numpy()
    for out in ranks:
        got = out["prefill_logits"]
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())


def test_long_context_decode_over_model_and_data_matches_one_device(ranks):
    """``seq_shard_cache`` at batch 1: the cache's 16 positions split over
    ('model', 'data'), 4 a rank, each rank writing and reading its own
    positions; the logits of all 16 steps on every rank within 1e-5 of the
    largest |logit| of one device's."""
    cfg = smoke_config("qwen2.5-3b")
    params = M.init_params(cfg, 0, device="cpu")
    cache = M.init_cache(cfg, 1, LONG, device="cpu")
    fed = torch.from_numpy(feed(1, LONG, cfg.vocab_size))
    for out in ranks:
        assert str(out["long_spec"]) == "Spec(None, None, ('model', 'data'), None)"
        assert int(out["long_split"]) == LONG // WORLD
    for pos in range(LONG):
        logits, cache = M.decode_step(params, cfg, fed[:, pos], cache, pos)
        want = logits.numpy()
        for out in ranks:
            got = out[f"long_logits_{pos}"]
            assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max()), pos


def test_knn_shards_with_mesh_host_is_refused():
    with pytest.raises(SystemExit):
        serve.main(ARGV + ["--knn-shards", "2", "--mesh", "host"])


def test_mesh_host_on_one_rank_falls_back(capsys, one_device):
    """One rank: ``--mesh host`` says so and serves the unsharded path."""
    toks = serve.main(ARGV + ["--mesh", "host"])
    assert "falling back to the UNSHARDED single-device path" in capsys.readouterr().out
    np.testing.assert_array_equal(toks, one_device["main_toks"])
