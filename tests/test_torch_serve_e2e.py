"""The serving drill on the port, end to end: client threads submit kNN
queries through the front-end while a writer streams insert/delete batches
through its scheduler and a socket-fed replica ships and replays the
leader's WAL the whole time.  Every ticket is checked exactly against
``brute_force_knn`` of the live set of the epoch that served it (no cohort
saw a tree swap mid-descent); at the end the replica is bitwise equal to
the leader.  Then ``launch/serve --smoke --knn --frontend --replicas 2``
on the CPU, and the reference's flag errors reproduced."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import smtree as T  # noqa: E402
from repro_torch.core.distributed import brute_force_knn  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serve.frontend import FrontendConfig, ServeFrontend  # noqa: E402
from repro_torch.stream import StreamingEngine, WriteAheadLog, ledger_digest  # noqa: E402
from repro_torch.stream.transport import ShippedReplica, WalShipServer  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

N, DIM, K = 600, 6, 3
N_CLIENTS, QUERIES_PER_CLIENT, WRITER_STEPS = 4, 15, 10


@pytest.mark.timeout(300)
def test_serve_e2e_drill(tmp_path):
    rng = np.random.default_rng(42)
    X = rng.random((N, DIM)).astype(np.float32)
    tree0 = T.bulk_build(X, capacity=8, device="cpu")
    wal = WriteAheadLog(str(tmp_path / "wal"), segment_max_records=4)
    leader = StreamingEngine(tree0, wal=wal)
    vec = {i: X[i] for i in range(N)}
    hist_lock = threading.Lock()
    history = {0: np.arange(N)}          # epoch -> its live oids
    errors = []
    fe = ServeFrontend(leader, FrontendConfig(cohort_width=8, slo_ms=10.0, k=K,
                                              max_frontier=256))

    def writer():
        wrng = np.random.default_rng(1)
        live, nid = set(range(N)), N
        try:
            for _ in range(WRITER_STEPS):
                ops, xs, oids = [], [], []
                for _ in range(24):
                    if live and wrng.random() < 0.5:
                        v = int(sorted(live)[wrng.integers(len(live))])
                        live.discard(v)
                        ops.append(T.OP_DELETE), oids.append(v), xs.append(vec[v])
                    else:
                        x = wrng.random(DIM).astype(np.float32)
                        vec[nid] = x
                        live.add(nid)
                        ops.append(T.OP_INSERT), oids.append(nid), xs.append(x)
                        nid += 1
                res = fe.submit_mutations(np.array(ops, np.int32),
                                          np.stack(xs).astype(np.float32),
                                          np.array(oids, np.int32)).result(120)
                assert (res.statuses == T.ST_APPLIED).all()
                with hist_lock:
                    history[leader.epochs.epoch] = np.array(sorted(live))
        except Exception as exc:  # noqa: BLE001 — surface to main thread
            errors.append(exc)

    def client(seed):
        crng = np.random.default_rng(seed)
        try:
            for _ in range(QUERIES_PER_CLIENT):
                q = crng.random(DIM).astype(np.float32)
                tk = fe.submit(q)
                d, ids = tk.result(120)
                deadline = time.monotonic() + 60
                while True:                     # the epoch's truth may land
                    with hist_lock:             # a beat after the publish
                        live = history.get(tk.epoch)
                    if live is not None:
                        break
                    assert time.monotonic() < deadline, f"epoch {tk.epoch} never recorded"
                    time.sleep(0.002)
                keys = np.stack([vec[o] for o in live])
                sd, si = brute_force_knn(keys, q[None], k=K, device="cpu")
                assert torch.equal(d, sd[0]), (d, sd[0])
                assert set(ids.tolist()) <= set(live.tolist())
                np.testing.assert_array_equal(
                    np.sort(ids.numpy()), np.sort(live[si[0].numpy()]))
        except Exception as exc:  # noqa: BLE001 — surface to main thread
            errors.append(exc)

    with WalShipServer(str(tmp_path / "wal"), wal=wal) as srv:
        rep = ShippedReplica(StreamingEngine(tree0), srv.address, str(tmp_path / "mirror"))
        with fe, rep:
            threads = [threading.Thread(target=writer, name="writer")]
            threads += [threading.Thread(target=client, args=(100 + i,), name=f"client-{i}")
                        for i in range(N_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=240)
            assert not any(th.is_alive() for th in threads), "drill hung"
            assert not errors, errors[0]
            fe.drain(timeout=60)
            seq, dg = ledger_digest(leader)
            rep.verify(seq, dg)
    for f in T.ARRAY_FIELDS:
        assert torch.equal(getattr(leader.tree, f), getattr(rep.follower.tree, f)), f
    s = fe.stats
    assert s.n_queries == N_CLIENTS * QUERIES_PER_CLIENT
    assert s.n_mutation_batches == WRITER_STEPS
    assert s.n_full_dispatch + s.n_deadline_dispatch == s.n_cohorts
    assert 1.0 <= s.mean_fill <= 8.0
    wal.close()


LM_ARGV = ["--smoke", "--knn", "--device", "cpu", "--batch", "2", "--prompt-len", "4",
           "--steps", "3"]


@pytest.mark.timeout(300)
def test_launch_serve_frontend_replicas_on_cpu(capsys):
    """``--knn --knn-mutate --frontend --replicas 2 --obs``: the tokens of
    the decode, the front-end's summary and an ``[obs]`` snapshot that
    covers the serving families; the replicas end caught up."""
    from repro_torch import obs
    try:
        toks = serve.main(LM_ARGV + ["--knn-mutate", "--frontend", "--replicas", "2",
                                     "--cohort-width", "4", "--slo-ms", "2", "--obs"])
    finally:
        obs.disable()
        obs.reset()
    assert toks.shape == (2, 4)
    out = capsys.readouterr().out
    assert "frontend:" in out and "2 replicas (max lag 0 records)" in out
    import json

    from repro_torch.obs.export import missing_rows
    snap = json.loads(next(ln for ln in out.splitlines()
                           if ln.startswith("[obs] "))[len("[obs] "):])
    assert missing_rows(snap, ["frontend.", "router.", "wal.", "replica.", "descent.",
                               "epoch.", "transport."]) == []
    m = snap["metrics"]
    assert m["frontend.queries_total"] == 2 * 3 and m["wal.appends_total"] == 2 * 3


@pytest.mark.timeout(120)
def test_launch_serve_frontend_tokens_equal_the_plain_stream():
    """The front-end changes where retrieval runs, not its answer: with no
    mutation in flight the decode's tokens with ``--frontend`` (cohorts of
    ``--batch`` rows, or of 3 with a row of padding) equal those without."""
    plain = serve.main(LM_ARGV)
    for width in ("0", "3"):
        fronted = serve.main(LM_ARGV + ["--frontend", "--cohort-width", width])
        np.testing.assert_array_equal(plain, fronted)


@pytest.mark.parametrize("argv", [
    ["--replicas", "2"],
    ["--knn-shards", "2"],
    ["--knn-shards", "2", "--frontend", "--replicas", "1"],
])
def test_launch_serve_flag_errors_match_the_reference(argv, capsys):
    from repro.launch import serve as jserve
    with pytest.raises(SystemExit) as je:
        jserve.main(["--smoke", "--knn"] + argv)
    want = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as te:
        serve.main(["--smoke", "--knn", "--device", "cpu"] + argv)
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert je.value.code == te.value.code == 2
    assert got.split("error: ", 1)[1] == want.split("error: ", 1)[1]


@pytest.mark.timeout(120)
def test_decode_split_tool_times_serve_loop_itself(monkeypatch):
    """``tools/serve_decode_split.py`` times ``serve_loop`` through its
    ``_split`` hook, not a copy of the loop: the hook leaves the tokens as
    they are, gives every step its parts, and the tool's per-thread CPU log
    sees the replicas' polls, with the replicas restarted as the tool's
    variants restart them."""
    import importlib.util
    from pathlib import Path

    from repro_torch.configs.all_archs import smoke_config
    from repro_torch.models import model as M
    from repro_torch.stream import pipeline, replica, transport

    path = Path(__file__).resolve().parents[1] / "tools" / "serve_decode_split.py"
    spec = importlib.util.spec_from_file_location("serve_decode_split", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    acct = tool.ThreadCpu()
    for owner, attr, label in tool.wrapped_functions(transport, replica, pipeline):
        monkeypatch.setattr(owner, attr, acct.wrap(getattr(owner, attr), label))
    plain = serve.main(LM_ARGV)
    args = serve.parser().parse_args(LM_ARGV + ["--frontend", "--replicas", "2"])
    cfg = smoke_config(args.arch)
    store = serve._build_store(args, cfg, "cpu")
    rows = []
    try:
        tool.set_replicas(store, "cpu_followers")
        with tool.LockProbe():
            toks, _ = serve.serve_loop(args, cfg, M.init_params(cfg, 0, device="cpu"), store,
                                       _split=rows)
        for rep in store.replicas:          # one idle round each, at least
            rep.poll()
        threads = acct.per_step([r["start"] for r in rows], float("inf"))
    finally:
        serve._finish_frontend(store, args)
    np.testing.assert_array_equal(toks, plain)
    assert len(rows) == args.steps
    assert all(set(r) == {"start", "decode", "mix"} for r in rows)
    assert all(set(r["decode"]) == {"host_ms", "cpu_ms", "sync_ms"} for r in rows)
    assert [r["start"] for r in rows] == sorted(r["start"] for r in rows)
    assert "MainThread/replica_poll" in threads
