"""The port's lease store, fence guard and ``promote`` (``repro_torch.
stream.lease``): the reference's cases on the port, a lease file written
by one package and read (and taken over) by the other, and
``core.distributed.promote_follower`` in its one-device form and its
``group=`` form over gloo at world size 4 (four rank subprocesses meeting
through a ``file://`` init, as ``test_torch_forest_dist.py`` does)."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.stream import lease as JL  # noqa: E402
from repro_torch.core import distributed as TD  # noqa: E402
from repro_torch.core import smtree as T  # noqa: E402
from repro_torch.stream import (DigestMismatch, FencedOut, Replica,  # noqa: E402
                                StreamingEngine, StreamingForest, WriteAheadLog,
                                ledger_digest, tree_digest)
from repro_torch.stream.lease import (FenceGuard, LeaseLost, LeaseStore,  # noqa: E402
                                      promote)
from repro_torch.stream.transport import ShippedReplica, WalShipServer  # noqa: E402
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
DIM = 6
WORLD = 4


class ManualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _batch(rng, n, start_oid):
    ops = np.full(n, T.OP_INSERT, np.int8)
    xs = rng.random((n, DIM)).astype(np.float32)
    oids = (start_oid + np.arange(n)).astype(np.int32)
    return ops, xs, oids


# -- lease store -----------------------------------------------------------

def test_lease_acquire_renew_expire_takeover(tmp_path):
    clock = ManualClock()
    store = LeaseStore(str(tmp_path / "lease"), ttl_s=10.0, clock=clock)
    a = store.try_acquire("a")
    assert a is not None and a.token == 0
    assert store.try_acquire("b") is None        # held, unexpired
    a2 = store.renew("a", a.token)
    assert a2.token == a.token                   # renewal: same term
    clock.t = 11.0                               # lease lapses
    b = store.try_acquire("b")
    assert b is not None and b.token == 1        # takeover: token bumps
    with pytest.raises(LeaseLost):
        store.renew("a", a.token)                # deposed
    store.release("b", b.token)
    assert store.read() is None
    c = store.try_acquire("c")
    assert c.token == 2                          # monotonic across release


def test_lease_reacquire_after_own_expiry_keeps_monotonicity(tmp_path):
    clock = ManualClock()
    store = LeaseStore(str(tmp_path / "lease"), ttl_s=1.0, clock=clock)
    a = store.try_acquire("a")
    clock.t = 2.0
    a2 = store.try_acquire("a")
    assert a2.token == a.token + 1


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_lease_file_is_shared_with_the_reference(tmp_path, writer):
    """One package writes the lease file, the other reads it, renews it,
    takes it over and releases it; the two write the same bytes."""
    clock = ManualClock()
    path = str(tmp_path / "lease")
    mods = {"port": LeaseStore, "reference": JL.LeaseStore}
    other = "reference" if writer == "port" else "port"
    a = mods[writer](path, ttl_s=5.0, clock=clock)
    b = mods[other](path, ttl_s=5.0, clock=clock)
    g = a.try_acquire("leader")
    seen = b.read()
    assert (seen.holder, seen.token, seen.expires_at) == (g.holder, g.token, g.expires_at)
    assert b.try_acquire("follower") is None     # live in the other's view
    a_bytes = open(path, "rb").read()
    b.renew("leader", g.token)                   # the other package renews it
    assert open(path, "rb").read() == a_bytes    # same JSON, same bytes
    clock.t = 6.0
    t = b.try_acquire("follower")
    assert t.token == g.token + 1
    with pytest.raises((LeaseLost, JL.LeaseLost)):
        a.renew("leader", g.token)
    b.release("follower", t.token)
    assert a.read() is None
    assert a.try_acquire("x").token == t.token + 1


# -- fencing ---------------------------------------------------------------

def test_fence_guard_blocks_deposed_leader(tmp_path):
    clock = ManualClock()
    store = LeaseStore(str(tmp_path / "lease"), ttl_s=5.0, clock=clock)
    rng = np.random.default_rng(0)
    grant = store.try_acquire("leader")
    wal = WriteAheadLog(str(tmp_path / "wal"),
                        fence=FenceGuard(store, "leader", grant.token))
    wal.append_batch(*_batch(rng, 4, 0))         # fine under own lease
    clock.t = 6.0
    takeover = store.try_acquire("usurper")
    assert takeover.token > grant.token
    seq_before = wal.next_seq
    seg = os.path.join(str(tmp_path / "wal"), sorted(os.listdir(tmp_path / "wal"))[-1])
    size_before = os.path.getsize(seg)
    with pytest.raises(FencedOut):
        wal.append_batch(*_batch(rng, 4, 100))
    assert wal.next_seq == seq_before            # no seq burn, no bytes
    assert os.path.getsize(seg) == size_before


# -- promotion -------------------------------------------------------------

def _run_leader(tmp_path, rng, *, steps=5):
    X = rng.random((300, DIM)).astype(np.float32)
    tree0 = T.bulk_build(X, capacity=8, device="cpu")
    wal = WriteAheadLog(str(tmp_path / "wal"), segment_max_records=3)
    leader = StreamingEngine(tree0, wal=wal)
    for i in range(steps):
        leader.insert_batch(rng.random((12, DIM)).astype(np.float32),
                            np.arange(1000 + 12 * i, 1012 + 12 * i, dtype=np.int32))
    return leader, wal, tree0


def test_promote_local_replica_takes_over_wal(tmp_path):
    clock = ManualClock()
    store = LeaseStore(str(tmp_path / "lease"), ttl_s=5.0, clock=clock)
    rng = np.random.default_rng(1)
    old_grant = store.try_acquire("leader")
    leader, wal, tree0 = _run_leader(tmp_path, rng)
    wal.fence = FenceGuard(store, "leader", old_grant.token)
    seq, dg = ledger_digest(leader)
    rep = Replica(StreamingEngine(tree0), str(tmp_path / "wal"))
    wal.close()                                   # the leader "dies"
    clock.t = 6.0
    promo = promote(rep, store, "follower-1", target=(seq, dg))
    assert promo.lease.token > old_grant.token
    assert promo.applied_seq == seq and promo.digest == dg
    new_leader = rep.follower
    assert new_leader.wal is promo.wal
    new_leader.insert_batch(rng.random((8, DIM)).astype(np.float32),
                            np.arange(5000, 5008, dtype=np.int32))
    assert promo.wal.next_seq == seq + 2          # seq numbering continues
    with pytest.raises(FencedOut):
        wal.append_batch(*_batch(rng, 4, 9000))
    promo.wal.close()


@pytest.mark.timeout(60)
def test_promote_shipped_replica_drains_dead_leaders_tail(tmp_path):
    """The crashed-leader drill: the leader process is gone but its disk
    (ship server) survives; the follower pulls the remaining tail through
    the socket, verifies the digest, and takes over."""
    clock = ManualClock()
    store = LeaseStore(str(tmp_path / "lease"), ttl_s=5.0, clock=clock)
    rng = np.random.default_rng(2)
    store.try_acquire("leader")
    leader, wal, tree0 = _run_leader(tmp_path, rng)
    seq, dg = ledger_digest(leader)
    with WalShipServer(str(tmp_path / "wal"), leader_seq_fn=lambda: seq) as srv:
        rep = ShippedReplica(StreamingEngine(tree0), srv.address, str(tmp_path / "mirror"))
        try:
            rep.poll()                    # partially caught up, then crash:
            wal.close()                   # the WAL handle dies, disk stays
            clock.t = 6.0
            promo = promote(rep, store, "follower-1", target=(seq, dg))
        finally:
            rep.stop()
    assert promo.applied_seq == seq and promo.digest == dg
    new_leader = rep.follower
    new_leader.insert_batch(rng.random((8, DIM)).astype(np.float32),
                            np.arange(5000, 5008, dtype=np.int32))
    assert new_leader.wal.next_seq == seq + 2
    with new_leader.epochs.reading() as pinned:
        assert tree_digest(pinned) != dg          # the write took
    promo.wal.close()


def test_promote_refuses_live_lease(tmp_path):
    clock = ManualClock()
    store = LeaseStore(str(tmp_path / "lease"), ttl_s=100.0, clock=clock)
    rng = np.random.default_rng(3)
    store.try_acquire("leader")
    leader, wal, tree0 = _run_leader(tmp_path, rng, steps=1)
    rep = Replica(StreamingEngine(tree0), str(tmp_path / "wal"))
    with pytest.raises(LeaseLost, match="not expired"):
        promote(rep, store, "follower-1")


# -- promote_follower ------------------------------------------------------

def _forest_inputs():
    rng = np.random.default_rng(11)
    X = rng.random((800, DIM)).astype(np.float32)
    Q = (X[:12] + rng.normal(0, 0.01, (12, DIM))).astype(np.float32)
    log = [(X[i:400:WORLD * 3], np.arange(i, 400, WORLD * 3, dtype=np.int32))
           for i in range(3)]
    return X, Q, log


def _forest_leader(wal_dir):
    """A streaming forest of 4 shards with a WAL: three delete batches.
    Returns the (seq, digest) of its last acknowledged state."""
    X, _, log = _forest_inputs()
    trees = TD.build_forest_trees(X, WORLD, capacity=8, device="cpu")
    sf = StreamingForest(trees, wal=WriteAheadLog(wal_dir, segment_max_records=2))
    for xs, oids in log:
        sf.delete_batch(xs, oids)
    out = ledger_digest(sf)
    sf.wal.close()
    return out


def test_promote_follower_one_device(tmp_path):
    X, Q, _ = _forest_inputs()
    seq, dg = _forest_leader(str(tmp_path / "wal"))
    trees = TD.build_forest_trees(X, WORLD, capacity=8, device="cpu")
    rep = Replica(StreamingForest(trees), str(tmp_path / "wal"))
    placed, epoch = TD.promote_follower(rep, device="cpu", expect=(seq, dg))
    assert placed.root.shape == (WORLD,) and rep.digest() == (seq, dg)
    d, i = TD.forest_knn(placed, Q, k=4, max_frontier=64)
    with rep.epochs.reading() as pinned:
        want = TD.forest_knn(TD.stack_trees(list(pinned)), Q, k=4, max_frontier=64)
    assert torch.equal(d, want[0]) and torch.equal(i, want[1])
    # a diverged follower may not serve
    rep2 = Replica(StreamingForest(trees), str(tmp_path / "wal"))
    with pytest.raises(DigestMismatch):
        TD.promote_follower(rep2, device="cpu", expect=(seq, "0" * 64), timeout=5.0)


_RANK = """
import sys
import numpy as np
import torch.distributed as dist
sys.path.insert(0, {tests!r})
import test_torch_lease as tl
from repro_torch.core import distributed as TD
from repro_torch.stream import Replica, StreamingForest

rank, init, wal_dir, seq, dg, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                     int(sys.argv[4]), sys.argv[5], sys.argv[6])
dist.init_process_group("gloo", init_method=init, rank=rank, world_size={world})
try:
    X, Q, _ = tl._forest_inputs()
    trees = TD.build_forest_trees(X, {world}, capacity=8, device="cpu")
    rep = Replica(StreamingForest(trees), wal_dir)
    shard, epoch = TD.promote_follower(rep, group=dist.group.WORLD, device="cpu",
                                       expect=(seq, dg))
    d, i = TD.forest_knn(shard, Q, k=4, max_frontier=64, group=dist.group.WORLD)
    np.savez(out + "." + str(rank) + ".npz", d=d.numpy(), i=i.numpy(), epoch=epoch,
             n=shard.n_objects)
finally:
    dist.destroy_process_group()
print("RANK_DONE", rank)
"""


@pytest.mark.timeout(300)
def test_promote_follower_group_over_gloo(tmp_path):
    """Each of 4 ranks replays the leader's WAL into its own follower,
    checks the digest and keeps its shard; ``forest_knn`` over the group
    equals the one-device form over the promoted forest."""
    X, Q, _ = _forest_inputs()
    seq, dg = _forest_leader(str(tmp_path / "wal"))
    code = textwrap.dedent(_RANK.format(tests=str(ROOT / "tests"), world=WORLD))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), init,
                               str(tmp_path / "wal"), str(seq), dg, str(tmp_path / "out")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_DONE {r}" in so, se[-3000:]
    trees = TD.build_forest_trees(X, WORLD, capacity=8, device="cpu")
    rep = Replica(StreamingForest(trees), str(tmp_path / "wal"))
    placed, epoch = TD.promote_follower(rep, device="cpu", expect=(seq, dg))
    d, i = TD.forest_knn(placed, Q, k=4, max_frontier=64)
    ranks = [dict(np.load(tmp_path / f"out.{r}.npz")) for r in range(WORLD)]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["d"], d.numpy())
        np.testing.assert_array_equal(res["i"], i.numpy())
        assert int(res["epoch"]) == epoch
        assert int(res["n"]) == TD.unstack_forest(placed)[r].n_objects
