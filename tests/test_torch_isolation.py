"""Port hygiene: the PyTorch package stands alone.

``repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor anything of
the JAX package ``repro``; importing the port builds no kernel; and the
smoke script refuses to run (non-zero exit, no result line) without a CUDA
card or outside a checkout of the repository.
"""
import ast
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _run(code: str, cwd=ROOT, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=timeout)


def test_port_runs_with_jax_blocked_and_loads_no_reference_module():
    proc = _run("""
        import sys
        sys.modules["jax"] = None          # any import of jax now fails
        import numpy as np
        import repro_torch.core.distributed, repro_torch.core.engine
        import repro_torch.core.convert, repro_torch.core.ref_impl
        from repro_torch.core.distributed import build_forest, forest_knn
        from repro_torch.core.engine import SMTreeEngine
        from repro_torch.data.datagen import clustered
        X = clustered(500, dims=6, seed=0)
        eng = SMTreeEngine.build(X, capacity=8, device="cpu")
        res = eng.knn(X[:4] + 0.01, k=3, max_frontier=64)
        eng.insert(X[0] + 0.5, 10_000)
        assert eng.delete(X[0] + 0.5, 10_000)
        assert eng.validate()
        forest = build_forest(X, 3, capacity=8, device="cpu")
        assert forest_knn(forest, X[:2], k=3)[1].shape == (2, 3)
        # the device passes and the host plane (repro_torch.stream)
        import repro_torch.stream
        from repro_torch.core import smtree
        ops = np.array([smtree.OP_INSERT] * 12 + [smtree.OP_DELETE] * 3, np.int32)
        xs = np.vstack([X[1] + 1e-4 * np.arange(12)[:, None], X[2:5]]).astype(np.float32)
        oids = np.concatenate([20_000 + np.arange(12), [2, 3, 4]]).astype(np.int32)
        _, st = smtree.apply_mutations(eng.tree, ops, xs, oids)
        assert smtree.ST_SPLIT in st.tolist()
        left = st.numpy().copy()
        assert repro_torch.stream.escalate_rows(eng.tree, left, ops, xs, oids) is eng.tree
        # the stream plane: WAL, epochs, snapshot + restore, a replica, the
        # forest's two planes, obs, the kNN-LM store's stream and the launcher
        import os, tempfile
        from repro_torch import obs
        from repro_torch.core.distributed import build_forest_trees, place_forest
        from repro_torch.dist.checkpoint import CheckpointManager
        from repro_torch.serve.frontend import pinned_knn
        from repro_torch.serve.knnlm import KnnLmConfig, KnnLmDatastore
        from repro_torch.launch import serve
        from repro_torch.stream import (Replica, StreamingEngine, StreamingForest,
                                        WriteAheadLog, ledger_digest, tree_digest)
        obs.enable()
        root = tempfile.mkdtemp()
        wal = WriteAheadLog(os.path.join(root, "wal"))
        ck = CheckpointManager(os.path.join(root, "ck"), async_write=False)
        se = StreamingEngine(eng.tree, wal=wal, ckpt=ck, max_batch=16)
        se.snapshot()
        se.delete_batch(X[100:140], np.arange(100, 140))
        rep = Replica.from_snapshot(os.path.join(root, "ck"), os.path.join(root, "wal"),
                                    device="cpu", max_batch=16)
        rep.verify(*ledger_digest(se))
        trees = build_forest_trees(X, 3, capacity=8, device="cpu")
        for mesh in (None, "cpu"):
            sf = StreamingForest(trees, mesh=mesh, rebalance_mode="incremental",
                                 min_objects=16, max_skew=1.2)
            sf.delete_batch(X[0:300:3], np.arange(0, 300, 3))
            assert sf.maintenance()
        assert pinned_knn(tuple(trees), X[:2], k=3, max_frontier=64)[1].shape == (2, 3)
        assert place_forest(trees, device="cpu").root.shape == (3,)
        store = KnnLmDatastore(KnnLmConfig(capacity=8), 6, device="cpu")
        store.build(X[:200], np.arange(200) % 7)
        store.enable_stream(shards=2)
        assert store.evict_batch(np.arange(20)) == 20
        assert store.knn_logits(X[:2], 7).shape == (2, 7)
        assert obs.export.metrics_snapshot()["metrics"]["stream.batches_total"] == 5
        assert serve.parser().parse_args(["--knn-mutate", "--obs"]).knn_mutate
        bad = sorted(m for m, v in sys.modules.items() if v is not None and
                     (m == "jax" or m.startswith("jax.") or m == "repro"
                      or m.startswith("repro.")))
        assert not bad, bad
        assert "repro_torch.kernels._build" not in sys.modules  # nothing built
        print("ok", res.dists.shape[1])
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok", "3"]


@pytest.mark.timeout(300)
def test_serving_plane_runs_with_jax_blocked():
    """The serving plane's modules (faults, transport, lease, front-end,
    router, ``promote_follower``, ``fetch_metrics``) import and run a
    shipped replica, a promotion and a routed read with ``jax`` blocked."""
    proc = _run("""
        import sys
        sys.modules["jax"] = None
        import os, tempfile
        import numpy as np
        from repro_torch.core import smtree
        from repro_torch.core.distributed import promote_follower
        from repro_torch.obs.export import fetch_metrics
        from repro_torch.serve.frontend import FrontendConfig, ServeFrontend
        from repro_torch.serve.router import ReplicaRouter
        from repro_torch.stream import (StreamingEngine, WriteAheadLog, ledger_digest)
        from repro_torch.stream.faults import FaultInjector, FaultPlan
        from repro_torch.stream.lease import LeaseStore, promote
        from repro_torch.stream.transport import ShippedReplica, WalShipServer
        X = np.random.default_rng(0).random((200, 6)).astype(np.float32)
        tree = smtree.bulk_build(X, capacity=8, device="cpu")
        root = tempfile.mkdtemp()
        wal = WriteAheadLog(os.path.join(root, "wal"), segment_max_records=2)
        leader = StreamingEngine(tree, wal=wal)
        fe = ServeFrontend(leader, FrontendConfig(cohort_width=2, k=2)).start()
        srv = WalShipServer(wal.directory, wal=wal,
                            fault=FaultInjector(FaultPlan(seed=1, drop_p=0.2))).start()
        rep = ShippedReplica(StreamingEngine(tree), srv.address, os.path.join(root, "m"))
        try:
            router = ReplicaRouter(fe, [rep], k=2)
            for i in range(3):
                router.mutate(np.ones(4, np.int32), X[:4] + 0.01 * (i + 1),
                              np.arange(1000 + 4 * i, 1004 + 4 * i, dtype=np.int32))
            seq, dg = ledger_digest(leader)
            rep.catch_up(seq)
            assert router.query(X[0]).result(30)[1].shape == (2,)
            assert "metrics" in fetch_metrics(srv.address)
            placed, epoch = promote_follower(rep, device="cpu", expect=(seq, dg))
            store = LeaseStore(os.path.join(root, "lease"), ttl_s=0.0)
            wal.close()
            promo = promote(rep, store, "f", target=(seq, dg))
            assert promo.digest == dg and placed.root.shape == (1,)
            promo.wal.close()
        finally:
            fe.stop()
            rep.stop()
            srv.stop()
        bad = sorted(m for m, v in sys.modules.items() if v is not None and
                     (m == "jax" or m.startswith("jax.") or m == "repro"
                      or m.startswith("repro.")))
        assert not bad, bad
        print("ok")
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok"]


def test_model_families_run_with_jax_blocked():
    """The MoE and Mamba modules (``models.moe``, ``models.ssm``) import
    and run jamba's and qwen2-moe's smoke models, forward and decode, with
    ``jax`` blocked, and load nothing of the JAX package."""
    proc = _run("""
        import sys
        sys.modules["jax"] = None
        import torch
        from repro_torch.configs import smoke_config
        from repro_torch.models import model as M, moe, ssm
        for arch in ("qwen2-moe-a2.7b", "jamba-v0.1-52b"):
            cfg = smoke_config(arch)
            params = M.init_params(cfg, 0, device="cpu")
            toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(0))
            logits, aux = M.forward(params, cfg, {"tokens": toks})
            cache = M.init_cache(cfg, 2, 4, device="cpu")
            lg, cache = M.decode_step(params, cfg, toks[:, 0], cache, 0)
            assert logits.shape[:2] == (2, 9) and lg.shape == logits[:, 0].shape
            assert float(aux["drop_frac"]) >= 0 and bool(torch.isfinite(lg).all())
        assert isinstance(params.blocks[0].mixer, ssm.Mamba)
        assert isinstance(params.blocks[1].ffn, moe.MoE)
        bad = sorted(m for m, v in sys.modules.items() if v is not None and
                     (m == "jax" or m.startswith("jax.") or m == "repro"
                      or m.startswith("repro.")))
        assert not bad, bad
        assert "repro_torch.kernels._build" not in sys.modules
        print("ok")
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok"]


def test_xlstm_and_encdec_run_with_jax_blocked():
    """The xLSTM blocks (``models.xlstm``) and the encoder-decoder
    (``models.encdec``) run xlstm-1.3b's and whisper-tiny's smoke models,
    forward, cache and decode, and ``launch/serve --knn`` for both, with
    ``jax`` blocked, and load nothing of the JAX package."""
    proc = _run("""
        import sys
        sys.modules["jax"] = None
        import torch
        from repro_torch.configs import smoke_config
        from repro_torch.launch import serve
        from repro_torch.models import model as M, encdec, xlstm
        g = torch.Generator().manual_seed(0)
        cfg = smoke_config("xlstm-1.3b")
        params = M.init_params(cfg, 0, device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=g)
        logits, _ = M.forward(params, cfg, {"tokens": toks})
        cache = M.init_cache(cfg, 2, 4, device="cpu")
        lg, cache = M.decode_step(params, cfg, toks[:, 0], cache, 0)
        assert torch.allclose(lg, logits[:, 0], atol=1e-4, rtol=1e-4)
        assert isinstance(params.blocks[0].mixer, xlstm.MLSTM)
        assert isinstance(params.blocks[7].mixer, xlstm.SLSTM)
        cfg = smoke_config("whisper-tiny")
        params = M.init_params(cfg, 0, device="cpu")
        assert isinstance(params, encdec.EncDec)
        frames = torch.randn((2, 20, cfg.d_model), generator=g)
        logits, _ = M.forward(params, cfg, {"frames": frames, "tokens": toks})
        cache = encdec.encdec_prefill_cache(params, cfg, frames,
                                            M.init_cache(cfg, 2, 20, device="cpu"))
        lg, cache = M.decode_step(params, cfg, toks[:, 0], cache, 0)
        assert torch.allclose(lg, logits[:, 0], atol=1e-4, rtol=1e-4)
        for arch in ("xlstm-1.3b", "whisper-tiny"):
            out = serve.main(["--smoke", "--arch", arch, "--knn", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "3", "--steps", "2"])
            assert out.shape == (2, 3)
        bad = sorted(m for m, v in sys.modules.items() if v is not None and
                     (m == "jax" or m.startswith("jax.") or m == "repro"
                      or m.startswith("repro.")))
        assert not bad, bad
        assert "repro_torch.kernels._build" not in sys.modules
        print("ok")
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_source_of_the_port_imports_jax_or_repro():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: imports {mod}"


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys, torch; torch.cuda.is_available = lambda: False; "
         "sys.argv = ['chip_smoke.py']; runpy.run_path('chip_smoke.py', run_name='__main__')"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
