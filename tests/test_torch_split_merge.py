"""Port parity: the device split and merge passes (``apply_splits``,
``apply_merges``, their ``resolve_*`` orchestration inside
``apply_mutations``), the free ring, headroom growth, ``move_objects``
with splits and merges on, and the host plane (``stream.batcher.
escalate_rows``), bitwise against the JAX package on the same numpy inputs.

Trees are compared field by field and by ``repro.stream.replica.tree_digest``
fed the port's numpy fields.  Each JAX split or merge scan compiles once
per array shape, so every tree is bulk-built by the JAX package and padded
to one node-table size per geometry (``pair``): growth of the table with
dead rows changes no allocation decision (the new ids are the highest).
"""
import dataclasses
import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import smtree as J  # noqa: E402
from repro.stream import batcher as JB  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core import smtree as T  # noqa: E402
from repro_torch.core.convert import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.core.engine import SMTreeEngine  # noqa: E402
from repro_torch.data.datagen import clustered  # noqa: E402
from repro_torch.stream import batcher as TB  # noqa: E402
from test_torch_mutations import (assert_same_tree, digest_of,  # noqa: E402
                                  every_status_log, jax_fields)
from _jax_caches import cleared_jax_caches  # noqa: E402,F401  (autouse)

# metric -> (capacity, dim): the three geometries of this file
GEOS = {"d_inf": (8, 5), "l2": (12, 7), "l1": (16, 10)}
N_FIXED = 1024
# per geometry, objects for a bulk build at fill 0.95 whose nodes are all
# near full over three levels (target fill ** 3)
FULL3 = {"d_inf": 343, "l2": 1331, "l1": 3375}
B_FIXED = 160          # every cohort of a split/merge case is padded to this
NEW = 100_000          # first id of inserted objects


def assert_port_trees_equal(a, b, msg=""):
    fa, ma = tree_to_numpy(a)
    fb, mb = tree_to_numpy(b)
    assert ma == mb, msg
    for f in T.ARRAY_FIELDS:
        np.testing.assert_array_equal(fa[f], fb[f], err_msg=f"{msg}{f}")


def pad_fields(arrays, meta, N):
    """The 16 fields padded to ``N`` node rows as the host's ``_grow`` lays
    them out, with the free ring recomputed."""
    arrays = dict(arrays)
    n0 = meta["max_nodes"]
    assert n0 <= N, (n0, N)
    for f in T.NODE_TABLE_FIELDS:
        if f == "free_list":
            continue
        a = arrays[f]
        pad = np.zeros((N - n0,) + a.shape[1:], a.dtype)
        if f in ("child", "oid", "parent", "pslot"):
            pad -= 1
        if f == "is_leaf":
            pad |= True
        arrays[f] = np.concatenate([a, pad])
    arrays["free_list"], arrays["free_head"] = J.packed_free_list(arrays["alive"])
    return arrays, dict(meta, max_nodes=N)


def pair(X, metric, *, N=N_FIXED, ids=None, **kw):
    """One JAX bulk build padded to ``N`` node rows: (JAX tree, port tree)."""
    cap, _ = GEOS[metric]
    jt = J.bulk_build(X, ids, capacity=cap, metric=metric, slack=1.0, **kw)
    arrays, meta = pad_fields(*jax_fields(jt), N)
    jt = J.TreeArrays(**{f: jnp.asarray(arrays[f]) for f in T.ARRAY_FIELDS}, **meta)
    return jt, tree_from_numpy(arrays, meta, "cpu")


def padded_log(rows, B=B_FIXED):
    """(ops, xs, oids) of ``rows`` [(op, x, oid)], NOP / -1 pads to ``B``."""
    dim = len(rows[0][1])
    rows = rows + [(J.OP_NOP, np.zeros(dim), -1)] * (B - len(rows))
    return (np.array([r[0] for r in rows], np.int32),
            np.array([r[1] for r in rows], np.float32),
            np.array([r[2] for r in rows], np.int32))


def both_apply(jt, tt, log, **kw):
    jt, jst = J.apply_mutations(jt, *log, **kw)
    out, tst = T.apply_mutations(tt, *log, **kw)
    assert out is tt and tst.dtype == torch.int32
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    return jt, tst.numpy()


def leaves_of(tt):
    """{leaf: its live ids}, and {level-1 node: its leaf children}."""
    a, _ = tree_to_numpy(tt)
    live = a["alive"] & a["is_leaf"]
    leaves = {int(n): a["oid"][n, :a["count"][n]].tolist() for n in np.nonzero(live)[0]}
    parents = {}
    for n in leaves:
        parents.setdefault(int(a["parent"][n]), []).append(n)
    return leaves, parents


def pile_rows(X, centres, per, rng, start=NEW):
    dim = X.shape[1]
    rows, oid = [], start
    for c in centres:
        for _ in range(per):
            rows.append((J.OP_INSERT, X[c] + rng.normal(0, 1e-3, dim), oid))
            oid += 1
    return rows


def internal_nodes(tt):
    return int((tt.alive & ~tt.is_leaf).sum())


# --------------------------------------------------------------------------
# promotion and partition
# --------------------------------------------------------------------------
def _partition_inputs(rng, cap, form, ties):
    m = cap + 1 if form == "split" else 2 * cap
    dim = 4
    V = (rng.integers(0, 3, (m, dim)) if ties else rng.random((m, dim))).astype(np.float32)
    D = np.abs(V[:, None, :] - V[None, :, :]).max(-1).astype(np.float32)
    leaf = rng.random() < 0.5
    Radd = (np.zeros(m) if leaf else
            rng.integers(0, 2, m) if ties else rng.random(m)).astype(np.float32)
    min_fill = int(np.ceil(0.4 * cap))
    if form == "split":
        n = m
        min_side = max(2, min(min_fill, m // 2), m - cap)
        max_moves = min_side
    else:
        n = int(rng.integers(cap + 1, 2 * cap + 1))
        min_side = max(2, max(min(min_fill, n // 2), n - cap))
        max_moves = cap
    return D, Radd, np.arange(m) < n, n, min_side, max_moves


@pytest.mark.parametrize("form", ["split", "merge"])
@pytest.mark.parametrize("ties", [False, True])
def test_promote_and_partition_bitwise_vs_jax(form, ties):
    """All ten outputs, on random and on tie-heavy distance matrices
    (integer-valued vectors under d_inf): the first minimal pair in
    row-major order, the rebalance's move order and the member order."""
    rng = np.random.default_rng([form == "split", ties])
    names = ("pi", "pj", "sel_i", "sel_j", "pres_i", "pres_j", "n_i", "n_j",
             "r_i", "r_j")
    for cap in (8, 16):
        t = types.SimpleNamespace(capacity=cap)
        for draw in range(6):
            D, Radd, uvalid, n, min_side, mm = _partition_inputs(rng, cap, form, ties)
            want = J._promote_and_partition(t, jnp.asarray(D), jnp.asarray(Radd),
                                            jnp.asarray(uvalid), n, min_side, mm)
            got = T._promote_and_partition(t, torch.from_numpy(D),
                                           torch.from_numpy(Radd),
                                           torch.from_numpy(uvalid), n, min_side, mm)
            for name, w, g in zip(names, want, got):
                np.testing.assert_array_equal(
                    g.numpy(), np.asarray(w),
                    err_msg=f"{form} ties={ties} cap={cap} draw={draw}: {name}")


# --------------------------------------------------------------------------
# the free ring
# --------------------------------------------------------------------------
def test_free_ring_push_pop_interleavings_bitwise():
    """Sorted-descending pushes and lowest-id pops, interleaved, equal to
    the JAX ring and to ``packed_free_list`` of the alive mask; the tail
    beyond ``free_head`` (zeros in a padded forest shard) shifts as JAX
    shifts it."""
    N = 32
    alive = np.ones(N, bool)
    alive[[3, 7, 19, 28]] = False
    fl, fh = J.packed_free_list(alive)
    fl[24:] = 0                       # a padded shard's tail
    jt = J.empty_tree(dim=2, capacity=4, max_nodes=N)
    jt = dataclasses.replace(jt, free_list=jnp.asarray(fl), free_head=jnp.asarray(fh))
    arrays, meta = jax_fields(jt)
    tt = tree_from_numpy(arrays, meta, "cpu")
    for step, (kind, f) in enumerate([("push", 12), ("pop", None), ("push", 1),
                                       ("push", 30), ("pop", None), ("pop", None),
                                       ("push", 5), ("push", 3), ("pop", None)]):
        if kind == "push":
            jt = J._push_free(jt, jnp.int32(f), jnp.asarray(True))
            T._push_free(tt, f)
            alive[f] = False
        else:
            jt, jn = J._pop_free(jt, jnp.asarray(True))
            tn = T._pop_free(tt)
            assert tn == int(jn)
            alive[tn] = True
        assert_same_tree(jt, tt, f"step {step} ")
        want_fl, want_fh = J.packed_free_list(alive)
        np.testing.assert_array_equal(tt.free_list[:want_fh].numpy(), want_fl[:want_fh])
        assert int(tt.free_head) == want_fh
    # a masked-off JAX pop and push leave the ring alone
    jt2, _ = J._pop_free(jt, jnp.asarray(False))
    jt2 = J._push_free(jt2, jnp.int32(9), jnp.asarray(False))
    assert_same_tree(jt2, tt)


# --------------------------------------------------------------------------
# the split pass
# --------------------------------------------------------------------------
@pytest.mark.parametrize("metric", sorted(GEOS))
def test_apply_splits_multi_level_and_root_growth_bitwise(metric):
    """Piles on the leaves of near-full nodes: single-level leaf splits,
    re-descents that find room, parent splits with the pending-set splice,
    and a new root, through ``apply_mutations`` (the fast scan, then the
    split pass) and ``apply_splits`` directly."""
    cap, dim = GEOS[metric]
    X = clustered(FULL3[metric], dims=dim, seed=3)
    jt, tt = pair(X, metric, fill_frac=0.95)
    h0, internal0 = int(tt.height), internal_nodes(tt)
    assert h0 == 3
    rng = np.random.default_rng(4)
    _, parents = leaves_of(tt)
    leaves, _ = leaves_of(tt)
    # every leaf child of three level-1 nodes gets a pile of three
    centres = [leaves[c][0] for p in sorted(parents)[:3] for c in parents[p]]
    rows = pile_rows(X, centres, 3, rng)
    statuses = []
    for c0 in range(0, len(rows), B_FIXED):
        jt, st_ = both_apply(jt, tt, padded_log(rows[c0:c0 + B_FIXED]))
        statuses.append(st_)
    assert_same_tree(jt, tt, f"{metric}: ")
    st_ = np.concatenate(statuses)
    assert (st_ == T.ST_SPLIT).sum() > 0 and not (st_ == T.ST_OVERFLOW).any()
    assert int(tt.height) == h0 + 1, "no root growth"
    # the root split and at least one level-1 split besides the new root
    assert internal_nodes(tt) >= internal0 + 3
    SMTreeEngine(tt).validate()
    # the pass alone, on rows that all overflow: a fresh pile of cap + 2
    leaves, _ = leaves_of(tt)
    full = [n for n, ids in leaves.items() if len(ids) == cap]
    extra = pile_rows(X, [leaves[full[0]][0] if full else 0], 4, rng, start=NEW + 50_000)
    ops, xs, oids = padded_log(extra, B=T.SPLIT_CHUNK)
    jt, jst = J.apply_splits(jt, ops, xs, oids)
    _, tst = T.apply_splits(tt, ops, xs, oids)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    assert set(tst.tolist()) == {T.ST_SPLIT, T.ST_NOP}
    assert_same_tree(jt, tt, f"{metric} direct: ")


def test_apply_splits_blocked_ring_carries_to_later_rows():
    """A ring of five free ids: the first split leaves four (enough for a
    height-3 tree), the second leaves three, then the next overflow row
    blocks, and it and every later overflow row report ST_OVERFLOW (the
    rows between still re-descend only while unblocked).  The residual
    overflow keeps the merge pass off in ``apply_mutations``."""
    cap, dim = GEOS["d_inf"]
    X = clustered(FULL3["d_inf"], dims=dim, seed=5)
    jb = J.bulk_build(X, capacity=cap, metric="d_inf", slack=1.0, fill_frac=0.95)
    jt, tt = pair(X, "d_inf", N=jb.max_nodes + 5, fill_frac=0.95)
    assert int(tt.free_head) == 5 and int(tt.height) == 3
    rng = np.random.default_rng(6)
    leaves, parents = leaves_of(tt)
    centres = [ids[0] for ids in list(leaves.values())[:12]]
    rows = pile_rows(X, centres, 3, rng)
    # underflow deletes: one leaf drained below min_fill
    victim = list(leaves.values())[-1]
    rows += [(J.OP_DELETE, X[o], o) for o in victim[:len(victim) - tt.min_fill + 2]]
    log = padded_log(rows, B=64)
    jt, st_ = both_apply(jt, tt, log)
    assert_same_tree(jt, tt)
    over = np.nonzero(st_ == T.ST_OVERFLOW)[0]
    assert len(over) > 0, "no row blocked"
    split_rows = np.nonzero(st_ == T.ST_SPLIT)[0]
    assert len(split_rows) > 0 and split_rows.max() < over.min()
    assert (st_ == T.ST_UNDERFLOW).any() and not (st_ == T.ST_MERGE).any()
    assert int(tt.free_head) < int(tt.height) + 1


# --------------------------------------------------------------------------
# the merge pass
# --------------------------------------------------------------------------
@pytest.mark.parametrize("metric", sorted(GEOS))
def test_apply_merges_both_branches_bitwise(metric, monkeypatch):
    """Under one level-1 node every leaf is thinned to min_fill by the fast
    path and one more delete underflows: its sibling has room, so the two
    merge.  Elsewhere, leaves drained next to near-full siblings
    redistribute.  Through ``apply_mutations`` and ``apply_merges``."""
    resplits = []
    partition = T._promote_and_partition
    monkeypatch.setattr(T, "_promote_and_partition", lambda t, D, *a, **kw: (
        resplits.append(D.shape[0]) or partition(t, D, *a, **kw)))
    cap, dim = GEOS[metric]
    X = clustered(FULL3[metric], dims=dim, seed=7)
    jt, tt = pair(X, metric, fill_frac=0.95)
    mf = tt.min_fill
    leaves, parents = leaves_of(tt)
    ps = sorted(parents)
    kids = parents[ps[0]]
    rows = [(J.OP_DELETE, X[o], o) for c in kids for o in leaves[c][mf:]]
    rows += [(J.OP_DELETE, X[o], o) for o in leaves[kids[0]][:2]]
    for p in ps[1:3]:
        c = parents[p][0]
        rows += [(J.OP_DELETE, X[o], o) for o in leaves[c][:len(leaves[c]) - mf + 2]]
    alive0 = int(tt.alive.sum())
    jt, st_ = both_apply(jt, tt, padded_log(rows))
    assert_same_tree(jt, tt, f"{metric}: ")
    assert (st_ == T.ST_MERGE).sum() >= 3 and not (st_ == T.ST_UNDERFLOW).any()
    assert int(tt.alive.sum()) < alive0, "no merge freed a node"
    assert resplits.count(2 * cap) >= 2, "no redistribution"
    SMTreeEngine(tt).validate()
    # the pass alone, on a few more deletes from one leaf
    leaves, _ = leaves_of(tt)
    ids = next(v for v in leaves.values() if len(v) == mf)
    ops = np.full(T.MERGE_CHUNK, T.OP_NOP, np.int32)
    oids = np.full(T.MERGE_CHUNK, -1, np.int32)
    ops[:3], oids[:3] = T.OP_DELETE, ids[:3]
    jt, jst = J.apply_merges(jt, ops, oids)
    _, tst = T.apply_merges(tt, ops, oids)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    assert tst[:3].tolist() == [T.ST_MERGE] * 3
    assert_same_tree(jt, tt, f"{metric} direct: ")


def test_apply_merges_cascade_to_root_collapse_and_singleton_root():
    """All but a handful of a small three-level tree's objects in one
    cohort: cascades up the levels, merges into a singleton root and root
    collapse down to a leaf, bitwise to JAX."""
    cap, dim = GEOS["d_inf"]
    X = clustered(60, dims=dim, seed=8)
    jt, tt = pair(X, "d_inf", fill_frac=0.5)
    assert int(tt.height) >= 3
    order = np.random.default_rng(8).permutation(60)
    rows = [(J.OP_DELETE, X[o], int(o)) for o in order[:56]]
    jt, st_ = both_apply(jt, tt, padded_log(rows))
    assert_same_tree(jt, tt)
    assert (st_[:56] == T.ST_MERGE).all()     # every leaf sits at min_fill
    assert int(tt.height) == 1 and tt.n_objects == 4
    assert int(tt.free_head) == int((~tt.alive).sum())
    SMTreeEngine(tt).validate()
    # regrowth: splits pop the freed ids, internal ones among them, as
    # leaves whose slots beyond the count keep stale nonzero radii, and
    # the appends after each split write their radius explicitly
    rng = np.random.default_rng(9)
    freed = ~tt.is_leaf & ~tt.alive
    assert bool((freed[:, None] & (tt.radius != 0)).any())
    for c in range(3):
        rows = pile_rows(X, order[56:] if c == 0 else rng.integers(0, 60, 6), 5, rng,
                         start=NEW + 100 * c)
        jt, st_ = both_apply(jt, tt, padded_log(rows))
        assert_same_tree(jt, tt, f"regrowth {c}: ")
        assert (st_ == T.ST_SPLIT).any()
    SMTreeEngine(tt).validate()


def test_merge_pad_rows_inert_against_a_planted_sentinel():
    """A stored -1 id: NOP / -1 pad rows and an explicit delete of -1
    touch nothing (ST_NOP / ST_NOTFOUND), as in JAX."""
    cap, dim = GEOS["d_inf"]
    X = clustered(200, dims=dim, seed=9)
    jt, tt = pair(X, "d_inf")
    leaf = int(np.nonzero((tt.alive & tt.is_leaf).numpy())[0][0])
    jt = dataclasses.replace(jt, oid=jt.oid.at[leaf, 0].set(-1))
    tt.oid[leaf, 0] = -1
    before = digest_of(tt)
    ops = np.full(T.MERGE_CHUNK, T.OP_NOP, np.int32)
    oids = np.full(T.MERGE_CHUNK, -1, np.int32)
    ops[-1] = T.OP_DELETE
    jt, jst = J.apply_merges(jt, ops, oids)
    _, tst = T.apply_merges(tt, ops, oids)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    assert tst.tolist() == [T.ST_NOP] * 7 + [T.ST_NOTFOUND]
    assert digest_of(tt) == before
    assert_same_tree(jt, tt)


# --------------------------------------------------------------------------
# apply_mutations and move_objects with both passes on
# --------------------------------------------------------------------------
@pytest.mark.parametrize("metric,seed", [("d_inf", 0), ("l2", 1), ("l1", 2)])
def test_apply_mutations_default_equals_jax_default(metric, seed):
    """The default call (splits and merges on) over two cohorts with every
    status, bitwise to JAX's default call: statuses, 16 fields, digest."""
    cap, dim = GEOS[metric]
    X = clustered(1200, dims=dim, seed=seed)
    jt, tt = pair(X, metric)
    rng = np.random.default_rng(seed)
    seen = set()
    for rnd in range(2):
        ops, xs, oids = every_status_log(X, rng)
        if rnd:
            oids = np.where(oids >= len(X) + 1000, oids + 100, oids).astype(np.int32)
        jt, jst = J.apply_mutations(jt, ops, xs, oids)
        _, tst = T.apply_mutations(tt, ops, xs, oids)
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        assert_same_tree(jt, tt, f"{metric} round {rnd}: ")
        seen |= set(tst.tolist())
    assert {T.ST_SPLIT, T.ST_MERGE, T.ST_NOTFOUND, T.ST_NOP} <= seen
    assert T.ST_OVERFLOW not in seen and T.ST_UNDERFLOW not in seen
    SMTreeEngine(tt).validate()


def test_cohort_stream_keeps_stale_slot_bytes_as_jax():
    """Delete-heavy and insert-heavy cohorts in turns: merges free internal
    nodes, splits reuse them as leaves whose slots beyond the count keep
    stale nonzero radii, and the next cohort's fast scan inserts there.
    The scan moves only what the reference's ``_apply_row`` moves (vecs,
    pdist, oid), so those bytes stay bitwise to JAX."""
    cap, dim = GEOS["d_inf"]
    X = clustered(300, dims=dim, seed=5)
    jt, tt = pair(X, "d_inf", fill_frac=0.5)
    rng = np.random.default_rng(5)
    live, vec, nid = set(range(300)), {i: X[i] for i in range(300)}, NEW
    stale = 0
    for rnd, frac in enumerate([0.9, 0.1, 0.1, 0.9, 0.1, 0.1]):
        a, _ = tree_to_numpy(tt)
        leaves = np.nonzero(a["alive"] & a["is_leaf"])[0]
        stale += sum(int(a["count"][n] < cap and a["radius"][n, a["count"][n]] != 0)
                     for n in leaves)
        log, nid = _random_stream(rng, live, vec, nid, B_FIXED, dim, frac)
        jt, _ = both_apply(jt, tt, log)
        assert_same_tree(jt, tt, f"round {rnd}: ")
    assert stale > 0, "no fast-scan insert met a stale slot"
    SMTreeEngine(tt).validate()


@pytest.mark.parametrize("splits,merges", [(True, False), (False, True)])
def test_apply_mutations_one_pass_on(splits, merges):
    cap, dim = GEOS["d_inf"]
    X = clustered(1200, dims=dim, seed=0)
    jt, tt = pair(X, "d_inf")
    ops, xs, oids = every_status_log(X, np.random.default_rng(0))
    jt, jst = J.apply_mutations(jt, ops, xs, oids, splits=splits, merges=merges)
    _, tst = T.apply_mutations(tt, ops, xs, oids, splits=splits, merges=merges)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    assert_same_tree(jt, tt)
    st_ = set(tst.tolist())
    assert (T.ST_SPLIT in st_) == splits and (T.ST_OVERFLOW in st_) == (not splits)
    # merges off, or on behind overflow rows that the split pass did not
    # take (so the merge pass does not run): the underflow rows stay
    assert T.ST_UNDERFLOW in st_ and T.ST_MERGE not in st_


def test_move_objects_with_splits_and_merges_bitwise():
    """A cluster moved out of one tree into another: the receiver's leaves
    overflow (placed through the split pass), the donor's underflow
    (moved through the merge pass)."""
    cap, dim = GEOS["d_inf"]
    X = clustered(1400, dims=dim, seed=10)
    dj, dt = pair(X[:700], "d_inf", ids=np.arange(700))
    rj, rt = pair(X[700:], "d_inf", ids=np.arange(700, 1400))
    leaves, _ = leaves_of(dt)
    move = np.array([o for ids in list(leaves.values())[:30] for o in ids]
                    + [99_999, -1], np.int32)
    dj, rj, wm = J.move_objects(dj, rj, move)
    d_out, r_out, gm = T.move_objects(dt, rt, move)
    assert d_out is dt and r_out is rt
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert gm[:-2].all() and not gm[-2:].any()
    assert_same_tree(dj, dt, "donor ")
    assert_same_tree(rj, rt, "receiver ")


# --------------------------------------------------------------------------
# headroom
# --------------------------------------------------------------------------
def test_grow_tree_and_needs_headroom_bitwise():
    X = clustered(200, dims=5, seed=11)
    jt = J.bulk_build(X, capacity=8)
    tt = tree_from_numpy(*jax_fields(jt), "cpu")
    for frac in (1 / 16, 0.25, 0.4, 0.0):
        assert T.needs_headroom(tt, frac=frac) == J.needs_headroom(jt, frac=frac)
    for factor in (2, 3):
        jg, tg = J.grow_tree(jt, factor=factor), T.grow_tree(tt, factor=factor)
        assert tg is not tt and tg.max_nodes == factor * tt.max_nodes
        assert_same_tree(jg, tg, f"factor {factor} ")
        assert not T.needs_headroom(tg, frac=0.25) or J.needs_headroom(jg, frac=0.25)
    assert tg.root.data_ptr() != tt.root.data_ptr()
    with pytest.raises(ValueError, match="factor"):
        T.grow_tree(tt, factor=1)
    # the watermark floor: a 16-row table can never hold MAX_HEIGHT + 1
    small = T.bulk_build(X[:60], capacity=8, slack=1.05, device="cpu")
    assert int(small.free_head) < T.MAX_HEIGHT + 1 and T.needs_headroom(small, frac=0.0)
    assert not T.needs_headroom(T.grow_tree(small, factor=4), frac=0.0)


def test_grown_tree_takes_the_same_mutations():
    """Growth changes no allocation decision: one cohort through the
    original and the grown tree leaves the same live rows."""
    X = clustered(500, dims=5, seed=12)
    t0 = T.bulk_build(X, capacity=8, device="cpu")
    tg = T.grow_tree(t0)
    rng = np.random.default_rng(12)
    leaves, _ = leaves_of(t0)
    log = padded_log(pile_rows(X, [ids[0] for ids in list(leaves.values())[:10]], 4, rng)
                     + [(J.OP_DELETE, X[o], o) for o in range(0, 120, 2)])
    _, s0 = T.apply_mutations(t0, *log)
    _, sg = T.apply_mutations(tg, *log)
    assert torch.equal(s0, sg) and (s0 == T.ST_SPLIT).any()
    N = t0.max_nodes
    for f in T.NODE_TABLE_FIELDS:
        if f != "free_list":
            assert torch.equal(getattr(t0, f), getattr(tg, f)[:N]), f
    for f in ("root", "height", "n_nodes"):
        assert int(getattr(t0, f)) == int(getattr(tg, f))


# --------------------------------------------------------------------------
# the host plane
# --------------------------------------------------------------------------
@pytest.mark.parametrize("metric", ["d_inf", "l2"])
def test_escalate_rows_bitwise_vs_jax(metric):
    cap, dim = GEOS[metric]
    X = clustered(1200, dims=dim, seed=13)
    jt, tt = pair(X, metric)
    log = every_status_log(X, np.random.default_rng(13))
    _, st_ = T.apply_mutations(tt, *log, splits=False, merges=False)
    arrays, meta = tree_to_numpy(tt)
    jt = J.TreeArrays(**{f: jnp.asarray(arrays[f]) for f in T.ARRAY_FIELDS}, **meta)
    sj, sp = st_.numpy().copy(), st_.numpy().copy()
    jt = JB.escalate_rows(jt, sj, *log)
    tt2 = TB.escalate_rows(tt, sp, *log)
    np.testing.assert_array_equal(sp, sj)
    assert not np.isin(sp, (T.ST_OVERFLOW, T.ST_UNDERFLOW)).any()
    assert_same_tree(jt, tt2)
    # nothing to escalate: the tree comes back as it was given
    assert TB.escalate_rows(tt2, sp, *log) is tt2


# --------------------------------------------------------------------------
# device passes == the port's host plane
# --------------------------------------------------------------------------
def _random_stream(rng, live, vec, nid, n, dim, del_frac):
    """A conflict-free cohort: deletes of ids live before it, inserts of
    new ids."""
    rows = []
    old = sorted(live)
    for _ in range(n):
        if old and rng.random() < del_frac:
            v = int(old.pop(rng.integers(len(old))))
            live.discard(v)
            rows.append((T.OP_DELETE, vec[v], v))
        else:
            v = rng.random(dim).astype(np.float32)
            vec[nid] = v
            live.add(nid)
            rows.append((T.OP_INSERT, v, nid))
            nid += 1
    return padded_log(rows, B=n), nid


def _normalised(st_):
    return np.where(np.isin(st_, (T.ST_SPLIT, T.ST_MERGE)), T.ST_APPLIED, st_)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 10_000))
def test_device_passes_equal_the_host_plane(seed):
    """Property: mixed streams through ``apply_mutations(True, True)`` (and
    ``escalate_rows`` for whatever a blocked ring leaves) equal the same
    streams through the fast scan alone and ``escalate_rows``, bitwise,
    with ``validate()`` and the live set of the log."""
    rng = np.random.default_rng(seed)
    dim = 5
    X = clustered(300, dims=dim, seed=seed % 97)
    slack = (1.0, 1.1, 1.5)[seed % 3]
    dev_t = T.bulk_build(X, capacity=8, fill_frac=0.9, slack=slack, seed=seed % 13,
                         device="cpu")
    host_t = T.bulk_build(X, capacity=8, fill_frac=0.9, slack=slack, seed=seed % 13,
                          device="cpu")
    live = set(range(300))
    vec = {i: X[i] for i in range(300)}
    nid = 1000
    resolved = 0
    for frac in (0.2, 0.8, 0.5):
        log, nid = _random_stream(rng, live, vec, nid, 48, dim, frac)
        _, sd = T.apply_mutations(dev_t, *log)
        sd = sd.numpy().copy()
        resolved += int(np.isin(sd, (T.ST_SPLIT, T.ST_MERGE)).sum())
        dev_t = TB.escalate_rows(dev_t, sd, *log)
        _, sh = T.apply_mutations(host_t, *log, splits=False, merges=False)
        sh = sh.numpy().copy()
        host_t = TB.escalate_rows(host_t, sh, *log)
        np.testing.assert_array_equal(_normalised(sd), sh)
        assert_port_trees_equal(dev_t, host_t, f"seed {seed}: ")
    assert resolved > 0
    a, _ = tree_to_numpy(dev_t)
    mask = a["valid"] & (a["alive"] & a["is_leaf"])[:, None]
    assert sorted(a["oid"][mask].tolist()) == sorted(live)
    SMTreeEngine(dev_t).validate()


def test_passes_never_fall_back_to_the_host_plane(monkeypatch):
    class NoHost:
        def __init__(self, *a, **kw):
            raise AssertionError("the device passes used the host plane")

    monkeypatch.setattr(TE, "_HostView", NoHost)
    X = clustered(1200, dims=5, seed=14)
    tt = T.bulk_build(X, capacity=8, fill_frac=0.6, device="cpu")
    log = every_status_log(X, np.random.default_rng(14))
    _, st_ = T.apply_mutations(tt, *log)
    assert {T.ST_SPLIT, T.ST_MERGE} <= set(st_.tolist())
    with pytest.raises(AssertionError, match="host plane"):
        TB.escalate_rows(tt, np.array([T.ST_OVERFLOW], np.int32), *(a[:1] for a in log))
