"""The port's observability plane end to end (the reference's
``test_obs_e2e.py`` on the port): one query ticket's spans form a single
connected trace across router -> front-end dispatch (and the replica-serve
leg), the mutation trace reaches the WAL/apply/publish spans and the
replica's replay leg, the snapshot covers the frontend, router, replica,
WAL and descent rows, ``fetch_metrics`` works over the ship-server socket,
and recovery resets the router's staleness gauges."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import smtree as T  # noqa: E402
from repro_torch.obs.export import fetch_metrics, metrics_snapshot, missing_rows  # noqa: E402
from repro_torch.serve.frontend import FrontendConfig, ServeFrontend  # noqa: E402
from repro_torch.serve.router import ReplicaRouter  # noqa: E402
from repro_torch.stream import Replica, StreamingEngine, WriteAheadLog  # noqa: E402
from repro_torch.stream.faults import FaultInjector, FaultPlan  # noqa: E402
from repro_torch.stream.transport import WalShipServer  # noqa: E402

N, DIM = 300, 6


@pytest.fixture
def obs_on(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_OBS_DUMP_DIR", str(tmp_path))
    obs.reset()
    obs.enable()
    obs.set_trace_sampling(1)        # trace every root: tests need them all
    yield
    obs.disable()
    obs.set_trace_sampling(obs.TRACE_SAMPLE_EVERY)
    obs.reset()


@pytest.fixture
def stack(tmp_path):
    """Leader engine + started front-end + one filesystem replica; the
    front-end is stopped after the test."""
    made = []

    def make(seed=0):
        X = np.random.default_rng(seed).random((N, DIM)).astype(np.float32)
        tree0 = T.bulk_build(X, capacity=8, device="cpu")
        leader = StreamingEngine(tree0, wal=WriteAheadLog(str(tmp_path / "wal")))
        fe = ServeFrontend(leader, FrontendConfig(cohort_width=4, slo_ms=5.0,
                                                  k=3, max_frontier=256)).start()
        made.append(fe)
        return X, leader, fe, Replica(StreamingEngine(tree0), str(tmp_path / "wal"))
    yield make
    for fe in made:
        fe.stop()


def _mutation(n=4, start=900):
    return (np.full(n, 1, np.int32), np.full((n, DIM), 0.5, np.float32),
            np.arange(start, start + n, dtype=np.int32))


@pytest.mark.timeout(60)
def test_leader_query_trace_is_connected(obs_on, stack):
    X, leader, fe, rep = stack()
    router = ReplicaRouter(fe, [rep], k=3, max_frontier=256)
    tk = router.query(np.random.default_rng(1).random(DIM).astype(np.float32))
    tk.result(30)
    records = obs.RECORDER.records()
    assert tk.trace_id is not None
    spans = obs.assemble_trace(records, tk.trace_id)
    names = {s["name"] for s in spans}
    assert {"router.query", "frontend.query", "frontend.cohort", "frontend.epoch_pin",
            "frontend.device_compute", "frontend.reply"} <= names
    assert obs.trace_connected(records, tk.trace_id)
    by_name = {s["name"]: s for s in spans}
    assert by_name["frontend.query"]["parent_id"] == by_name["router.query"]["span_id"]
    assert by_name["frontend.query"]["attrs"]["epoch"] == tk.epoch


@pytest.mark.timeout(60)
def test_replica_query_trace_is_connected(obs_on, stack):
    X, leader, fe, rep = stack(seed=2)
    router = ReplicaRouter(fe, [rep], k=3, max_frontier=256, prefer_replicas=True)
    tk = router.query(np.random.default_rng(3).random(DIM).astype(np.float32))
    tk.result(30)
    assert tk.mode == "replica"
    records = obs.RECORDER.records()
    names = {s["name"] for s in obs.assemble_trace(records, tk.trace_id)}
    assert {"router.query", "router.replica_serve"} <= names
    assert obs.trace_connected(records, tk.trace_id)


@pytest.mark.timeout(60)
def test_cohort_links_join_coalesced_tickets(obs_on, stack):
    X, leader, fe, rep = stack(seed=4)
    router = ReplicaRouter(fe, [rep], k=3, max_frontier=256)
    qs = np.random.default_rng(5).random((4, DIM)).astype(np.float32)
    tickets = [router.query(q) for q in qs]
    [t.result(30) for t in tickets]
    records = obs.RECORDER.records()
    assert [s for s in obs.RECORDER.spans() if s["name"] == "frontend.cohort"]
    for tk in tickets:
        names = {s["name"] for s in obs.assemble_trace(records, tk.trace_id)}
        assert "frontend.cohort" in names       # direct child or via link
        assert obs.trace_connected(records, tk.trace_id)


@pytest.mark.timeout(60)
def test_mutation_trace_reaches_wal_apply_publish(obs_on, stack):
    X, leader, fe, rep = stack(seed=6)
    router = ReplicaRouter(fe, [rep], k=3, max_frontier=256)
    router.mutate(*_mutation())
    records = obs.RECORDER.records()
    (root,) = [s for s in obs.RECORDER.spans() if s["name"] == "router.mutate"]
    names = {s["name"] for s in obs.assemble_trace(records, root["trace_id"])}
    assert {"router.mutate", "frontend.mutation", "frontend.mutation_batch",
            "mutation.wal_append", "mutation.apply", "mutation.publish"} <= names
    assert obs.trace_connected(records, root["trace_id"])
    assert rep.poll() == 1
    (replay,) = [s for s in obs.RECORDER.spans() if s["name"] == "replica.replay"]
    assert replay["attrs"]["first_seq"] == 0 and replay["attrs"]["last_seq"] == 0


@pytest.mark.timeout(60)
def test_snapshot_covers_every_layer(obs_on, stack):
    X, leader, fe, rep = stack(seed=7)
    router = ReplicaRouter(fe, [rep], k=3, max_frontier=256)
    router.mutate(*_mutation())
    router.query(np.random.default_rng(8).random(DIM).astype(np.float32)).result(30)
    rep.poll()
    router.heartbeat()
    router.snapshot()
    snap = metrics_snapshot()
    assert missing_rows(snap, ["frontend.", "router.", "wal.", "replica.", "descent.",
                               "epoch."]) == []
    m = snap["metrics"]
    assert m["descent.queries_total"] >= 1
    assert m["descent.dist_evals_total"] > 0
    assert m["descent.nodes_visited_total"] > 0
    assert m["frontend.latency_s.count"] >= 1


@pytest.mark.timeout(60)
def test_fetch_metrics_over_ship_socket(obs_on, tmp_path):
    obs.counter("wal.appends_total").inc(2)
    wal = WriteAheadLog(str(tmp_path / "wal"))
    wal.append_batch(*_mutation(n=2))
    try:
        with WalShipServer(str(tmp_path / "wal"), wal=wal) as srv:
            snap = fetch_metrics(srv.address)
            again = fetch_metrics(srv.address)
    finally:
        wal.close()
    assert snap["enabled"] is True
    assert snap["metrics"]["wal.appends_total"] == 3
    assert set(again["metrics"]) == set(metrics_snapshot()["metrics"])


@pytest.mark.timeout(60)
def test_recovery_resets_staleness_gauges(obs_on, stack):
    X, leader, fe, rep = stack(seed=9)
    rep.poll()
    router = ReplicaRouter(fe, [rep], fault=FaultInjector(FaultPlan(seed=0,
                                                                    heartbeat_drop_p=1.0)),
                           miss_limit=3, k=3, max_frontier=256)
    for _ in range(3):
        router.heartbeat()
    assert not router.leader_up
    assert router.snapshot()["staleness"] >= 0
    g = obs.REGISTRY.snapshot()
    assert g["router.leader_up"] == 0.0 and g["router.consecutive_misses"] == 3
    router.fault = FaultInjector(FaultPlan())
    assert router.heartbeat()
    s_up = router.snapshot()
    assert s_up["leader_up"] and s_up["staleness"] == 0
    assert 0.0 <= s_up["time_since_heartbeat_s"] < 5.0
    g = obs.REGISTRY.snapshot()
    assert g["router.leader_up"] == 1.0 and g["router.consecutive_misses"] == 0
    assert g["router.staleness"] == 0.0
    assert 0.0 <= g["router.time_since_heartbeat_s"] < 5.0
    events = [e["name"] for e in obs.RECORDER.events()]
    assert "router.leader_down" in events and "router.leader_recovered" in events
