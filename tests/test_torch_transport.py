"""The port's WAL shipping (``repro_torch.stream.transport``) on the CPU:
the reference's cases (a byte-identical mirror, resume under live appends,
convergence under frame faults, kill and restart of either end, the
``ShippedReplica`` composition), the shipped follower's ``tree_digest``
against the reference's engine replaying the same WAL, the wire pulled
across the two packages, the seal of a segment at the leader's length
(scripted, beside the reference's client, which seals it short), and the
background pump under drop and reorder on 20 seeds.

Every test binds port 0 on 127.0.0.1 and stops its threads in ``finally``
(or a ``with``); none asserts on anything a sleep decides.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.stream as JS  # noqa: E402
from repro.core import smtree as J  # noqa: E402
from repro.stream import transport as JT  # noqa: E402
from repro_torch.core import smtree as T  # noqa: E402
from repro_torch.stream import (StreamingEngine, WriteAheadLog,  # noqa: E402
                                ledger_digest, tree_digest)
from repro_torch.stream.faults import FaultInjector, FaultPlan  # noqa: E402
from repro_torch.stream.transport import (ShippedReplica, ShipStall,  # noqa: E402
                                          TransportError, WalShipClient,
                                          WalShipServer)
from repro_torch.stream.wal import _scan_dir  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

DIM = 6
PUMP_SEEDS = list(range(6, 26))


def _batch(rng, n, start_oid):
    ops = np.full(n, T.OP_INSERT, np.int8)
    xs = rng.random((n, DIM)).astype(np.float32)
    oids = (start_oid + np.arange(n)).astype(np.int32)
    return ops, xs, oids


def _dir_bytes(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in _scan_dir(d)}


def _pump(client, wal_dir, *, rounds=400):
    """Poll until the mirror holds every leader byte (bounded)."""
    want = sum(os.path.getsize(os.path.join(wal_dir, n)) for n in _scan_dir(wal_dir))
    got = 0
    for _ in range(rounds):
        client.poll()
        got = sum(os.path.getsize(os.path.join(client.mirror_dir, n))
                  for n in _scan_dir(client.mirror_dir))
        if got >= want:
            return
    raise AssertionError(f"mirror stuck at {got}/{want} bytes")


def _tree0(seed):
    X = np.random.default_rng(seed).random((300, DIM)).astype(np.float32)
    return X, T.bulk_build(X, capacity=8, device="cpu")


@pytest.mark.timeout(60)
def test_ship_mirror_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    wal = WriteAheadLog(str(tmp_path / "wal"), segment_max_records=3)
    for i in range(8):
        wal.append_batch(*_batch(rng, 16, 100 * i))
    with WalShipServer(str(tmp_path / "wal"), wal=wal) as srv:
        client = WalShipClient(srv.address, str(tmp_path / "mirror"))
        try:
            _pump(client, str(tmp_path / "wal"))
        finally:
            client.close()
    assert _dir_bytes(str(tmp_path / "wal")) == _dir_bytes(str(tmp_path / "mirror"))
    assert client.leader_seq == 7


@pytest.mark.timeout(60)
def test_ship_resumes_and_tracks_live_appends(tmp_path):
    rng = np.random.default_rng(1)
    wal = WriteAheadLog(str(tmp_path / "wal"), segment_max_records=4)
    wal.append_batch(*_batch(rng, 8, 0))
    with WalShipServer(str(tmp_path / "wal"), wal=wal) as srv:
        client = WalShipClient(srv.address, str(tmp_path / "mirror"))
        try:
            _pump(client, str(tmp_path / "wal"))
            for i in range(1, 10):          # keep appending under shipping
                wal.append_batch(*_batch(rng, 8, 100 * i))
                _pump(client, str(tmp_path / "wal"))
        finally:
            client.close()
    assert _dir_bytes(str(tmp_path / "wal")) == _dir_bytes(str(tmp_path / "mirror"))


@pytest.mark.timeout(60)
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_ship_converges_under_frame_faults(tmp_path, seed):
    """Drop/dup/reorder/torn injection: the append-at-size invariant plus
    resync-truncate must still converge to a byte-identical mirror."""
    rng = np.random.default_rng(seed)
    wal = WriteAheadLog(str(tmp_path / "wal"), segment_max_records=3)
    for i in range(10):
        wal.append_batch(*_batch(rng, 24, 100 * i))
    fault = FaultInjector(FaultPlan(seed=seed, drop_p=0.1, dup_p=0.1,
                                    reorder_p=0.1, torn_p=0.05))
    with WalShipServer(str(tmp_path / "wal"), wal=wal, fault=fault,
                       chunk_bytes=256) as srv:
        client = WalShipClient(srv.address, str(tmp_path / "mirror"), seed=seed)
        try:
            _pump(client, str(tmp_path / "wal"), rounds=2000)
        finally:
            client.close()
    assert _dir_bytes(str(tmp_path / "wal")) == _dir_bytes(str(tmp_path / "mirror"))
    assert sum(fault.counts.values()) > 0


@pytest.mark.timeout(60)
def test_ship_server_kill_and_restart(tmp_path):
    rng = np.random.default_rng(3)
    wal = WriteAheadLog(str(tmp_path / "wal"), segment_max_records=4)
    wal.append_batch(*_batch(rng, 8, 0))
    srv = WalShipServer(str(tmp_path / "wal"), wal=wal).start()
    client = WalShipClient(srv.address, str(tmp_path / "mirror"))
    try:
        _pump(client, str(tmp_path / "wal"))
        srv.stop()                              # leader endpoint dies
        wal.append_batch(*_batch(rng, 8, 100))
        with pytest.raises(TransportError):
            for _ in range(3):                  # an in-flight round may still
                client.poll()                   # be served; then refused/broken
        srv.start()                             # rebinds the same port
        _pump(client, str(tmp_path / "wal"))
        assert _dir_bytes(str(tmp_path / "wal")) == _dir_bytes(str(tmp_path / "mirror"))
    finally:
        client.close()
        srv.stop()


@pytest.mark.timeout(60)
def test_ship_client_kill_and_restart_resyncs(tmp_path):
    """A new client over an existing mirror resumes from the mirror's
    scanned valid length — no re-shipping from zero, no duplication."""
    rng = np.random.default_rng(4)
    wal = WriteAheadLog(str(tmp_path / "wal"), segment_max_records=4)
    for i in range(4):
        wal.append_batch(*_batch(rng, 8, 100 * i))
    with WalShipServer(str(tmp_path / "wal"), wal=wal) as srv:
        c1 = WalShipClient(srv.address, str(tmp_path / "mirror"))
        try:
            _pump(c1, str(tmp_path / "wal"))
        finally:
            c1.close()                          # killed
        names = _scan_dir(str(tmp_path / "mirror"))
        with open(os.path.join(str(tmp_path / "mirror"), names[-1]), "ab") as f:
            f.write(b"\x07garbage")             # dying mid-append
        for i in range(4, 7):
            wal.append_batch(*_batch(rng, 8, 100 * i))
        c2 = WalShipClient(srv.address, str(tmp_path / "mirror"))
        try:
            _pump(c2, str(tmp_path / "wal"))
        finally:
            c2.close()
    assert _dir_bytes(str(tmp_path / "wal")) == _dir_bytes(str(tmp_path / "mirror"))


def _leader_run(tmp_path, seed, n_batches, rows, first_oid):
    rng = np.random.default_rng(seed)
    X, tree0 = _tree0(seed)
    wal = WriteAheadLog(str(tmp_path / "wal"), segment_max_records=3)
    leader = StreamingEngine(tree0, wal=wal)
    batches = [(rng.random((rows, DIM)).astype(np.float32),
                np.arange(first_oid + rows * i, first_oid + rows * (i + 1), dtype=np.int32))
               for i in range(n_batches)]
    return X, tree0, wal, leader, batches


@pytest.mark.timeout(60)
def test_shipped_replica_end_to_end_and_equal_to_the_reference_replay(tmp_path):
    """A ``ShippedReplica`` verifies bitwise across the socket, and the
    reference's engine replaying the same WAL reaches the same digest."""
    X, tree0, wal, leader, batches = _leader_run(tmp_path, 5, 6, 12, 1000)
    with WalShipServer(str(tmp_path / "wal"), wal=wal) as srv:
        rep = ShippedReplica(StreamingEngine(tree0), srv.address, str(tmp_path / "mirror"))
        try:
            for xs, oids in batches:
                leader.insert_batch(xs, oids)
            seq, dg = ledger_digest(leader)
            rep.catch_up(seq)
            rep.verify(seq, dg)                 # bitwise across the socket
            assert rep.lag == 0
        finally:
            rep.stop()
    jrep = JS.Replica(JS.StreamingEngine(J.bulk_build(X, capacity=8)), str(tmp_path / "mirror"))
    jrep.run_until(seq)
    assert jrep.digest() == (seq, dg) == rep.digest()


@pytest.mark.timeout(60)
def test_reference_client_pulls_from_the_port_server(tmp_path):
    """The reference's client ignores the ``sizes`` key: it mirrors the
    port's server byte for byte over several segments."""
    rng = np.random.default_rng(7)
    wal = WriteAheadLog(str(tmp_path / "wal"), segment_max_records=3)
    for i in range(8):
        wal.append_batch(*_batch(rng, 16, 100 * i))
    with WalShipServer(str(tmp_path / "wal"), wal=wal) as srv:
        client = JT.WalShipClient(srv.address, str(tmp_path / "mirror"))
        try:
            _pump(client, str(tmp_path / "wal"))
        finally:
            client.close()
    assert _dir_bytes(str(tmp_path / "wal")) == _dir_bytes(str(tmp_path / "mirror"))
    assert len(_scan_dir(str(tmp_path / "wal"))) == 3


@pytest.mark.timeout(60)
def test_port_client_pulls_from_the_reference_server_within_a_segment(tmp_path):
    """The reference's server sends no segment lengths: the port's client
    mirrors its first segment byte for byte, then does not advance (it
    cannot tell a finished segment from a dropped chunk) and reports the
    stall once the leader has moved on."""
    rng = np.random.default_rng(8)
    wal = WriteAheadLog(str(tmp_path / "wal"), segment_max_records=3)
    for i in range(3):
        wal.append_batch(*_batch(rng, 16, 100 * i))
    with JT.WalShipServer(str(tmp_path / "wal"), wal=wal) as srv:
        client = WalShipClient(srv.address, str(tmp_path / "mirror"), max_stall_rounds=5)
        try:
            _pump(client, str(tmp_path / "wal"))
            assert _dir_bytes(str(tmp_path / "wal")) == _dir_bytes(str(tmp_path / "mirror"))
            wal.append_batch(*_batch(rng, 16, 900))          # segment 1
            with pytest.raises(ShipStall):
                for _ in range(10):
                    client.poll()
        finally:
            client.close()
    assert _scan_dir(str(tmp_path / "mirror")) == _scan_dir(str(tmp_path / "wal"))[:1]


class _DropSegmentOnce:
    """A scripted injector: in its first round with a chunk of segment
    ``seg`` and one of ``seg + 1``, drop every chunk of ``seg`` (the round
    ``[(seg + 1, 0)]``); pass everything else untouched."""

    def __init__(self, seg):
        self.seg, self.fired = seg, False

    def filter(self, chunks):
        segs = {h["segment"] for h, _ in chunks}
        if not self.fired and {self.seg, self.seg + 1} <= segs:
            self.fired = True
            return [(h, b) for h, b in chunks if h["segment"] != self.seg]
        return chunks

    def torn(self, body):
        return body

    def maybe_delay(self):
        pass


@pytest.mark.timeout(60)
@pytest.mark.parametrize("client_pkg", ["port", "reference"])
def test_seal_waits_for_the_leaders_length(tmp_path, client_pkg):
    """The mirror holds segment 0 whole but short (2 of its 3 records) when
    the leader fills it and rotates; the next round delivers only segment
    1's first chunk.  The port's client refuses to seal segment 0 short and
    ends byte-identical to the leader, its replica at the leader's digest.
    The reference's client, fed the same round by the same server, seals
    segment 0 short and never recovers the missing record."""
    X, tree0, wal, leader, batches = _leader_run(tmp_path, 9, 4, 10, 3000)
    fault = _DropSegmentOnce(0)
    make = WalShipClient if client_pkg == "port" else JT.WalShipClient
    with WalShipServer(str(tmp_path / "wal"), wal=wal, fault=fault) as srv:
        client = make(srv.address, str(tmp_path / "mirror"))
        try:
            for xs, oids in batches[:2]:
                leader.insert_batch(xs, oids)
            _pump(client, str(tmp_path / "wal"))          # segment 0: 2 records
            for xs, oids in batches[2:]:                  # record 2, rotate, 3
                leader.insert_batch(xs, oids)
            names = _scan_dir(str(tmp_path / "wal"))
            assert names == ["segment_00000000.wal", "segment_00000001.wal"]
            client.poll()                                 # the scripted round
            assert fault.fired
            for _ in range(5):
                client.poll()
        finally:
            client.close()
    leader_b, mirror_b = _dir_bytes(str(tmp_path / "wal")), _dir_bytes(str(tmp_path / "mirror"))
    assert leader_b["segment_00000001.wal"] == mirror_b["segment_00000001.wal"]
    seq, dg = ledger_digest(leader)
    follower = JS.Replica(JS.StreamingEngine(J.bulk_build(X, capacity=8)),
                          str(tmp_path / "mirror"))
    if client_pkg == "port":
        assert mirror_b == leader_b
        follower.run_until(seq)
        assert follower.digest() == (seq, dg)
    else:
        # the reference seals segment 0 short: a hole at seq 2
        assert len(mirror_b["segment_00000000.wal"]) < len(leader_b["segment_00000000.wal"])
        assert [r.seq for r in JS.iter_wal(str(tmp_path / "mirror"))] == [0, 1, 3]
        with pytest.raises(JS.DigestMismatch):
            follower.verify(seq, dg, timeout=5.0)


@pytest.mark.timeout(120)
def test_shipped_replica_background_pump_under_faults(tmp_path):
    """The reference's flaky case on the port, on 20 seeds: 5% drop and 5%
    reorder on every shipped chunk, the pump in the background, the leader
    rotating every 3 records; every seed verifies bitwise."""
    for seed in PUMP_SEEDS:
        root = tmp_path / f"s{seed}"
        rng = np.random.default_rng(seed)
        _, tree0 = _tree0(seed)
        wal = WriteAheadLog(str(root / "wal"), segment_max_records=3)
        leader = StreamingEngine(tree0, wal=wal)
        fault = FaultInjector(FaultPlan(seed=seed, drop_p=0.05, reorder_p=0.05))
        with WalShipServer(str(root / "wal"), wal=wal, fault=fault, chunk_bytes=512) as srv:
            with ShippedReplica(StreamingEngine(tree0), srv.address, str(root / "mirror"),
                                seed=seed) as rep:
                for i in range(5):
                    leader.insert_batch(rng.random((10, DIM)).astype(np.float32),
                                        np.arange(2000 + 10 * i, 2010 + 10 * i,
                                                  dtype=np.int32))
                seq, dg = ledger_digest(leader)
                rep.verify(seq, dg, timeout=60.0)
        assert _dir_bytes(str(root / "wal")) == _dir_bytes(str(root / "mirror")), seed
        wal.close()
    with leader.epochs.reading() as pinned:
        assert tree_digest(pinned) == dg

