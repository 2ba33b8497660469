#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port of the SM-tree engine.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc; it exits non-zero without them.  It imports only
``repro_torch`` (from ``src/`` beside this file), torch, numpy and the
standard library, and prints one JSON line per phase:

  1. device: the card's name, the device count and nvidia-smi's name and
     power limit;
  2. build: nvcc build seconds of every kernel and its -Xptxas -v summary;
  3. each kernel against its plain PyTorch version at the main path's
     shapes (frontier scorer: bitwise for d_inf/l2/l1, filter off and on;
     distance scan: d_inf bitwise, sqeuclidean/ip within 1e-5), with
     CUDA-event times of the kernel, the plain version and the library
     call that computes the same function, where there is one;
  4. the main path at full size: 1,000,000 clustered 20-d objects, bulk
     build, kNN at the bench geometry (k=10, max_frontier=64, b=1024) and at
     the smallest exact geometry (max_frontier 2048..16384, b=256) held
     bitwise against the kernel-backed brute-force scan, the device time
     of one cohort by kernel (torch.profiler), range search held against
     the scan;
  5. Insert/Delete with leaf splits and merges, validate(), and the exact
     kNN check again against a scan of the updated set;
  then the kernel launch counts of that main path (phases 4-5, counters
  zeroed just before), and, outside the count,
  6. the cohort descent through the kernels against the same descent
     through the plain scorer, bitwise (all five result fields and the
     level-stat stacks), on the d_inf tree and on 100k-object l2/l1 trees.

The last two lines are nvidia-smi's name and power limit and
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

K = 10
BENCH_F = 64
EXACT_FS = (2048, 4096, 8192, 16384)
FULL = dict(n=1_000_000, dims=20, capacity=32, b_bench=1024, b_exact=256,
            b_parity=128, b_recheck=64, n_small=100_000, kernel_b=1024,
            kernel_F=64, kernel_N=50_000, dist_nq=1024, dist_ne=65_536,
            n_insert=300, timing_reps=5)
H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12       # f32 outside the tensor cores


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = nops / H100_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run(cfg: dict, device: str):
    import numpy as np
    import torch

    from repro_torch.core import smtree
    from repro_torch.core.distributed import brute_force_knn
    from repro_torch.core.engine import SMTreeEngine
    from repro_torch.data.datagen import clustered
    from repro_torch.kernels import _build
    from repro_torch.kernels.distance import (pairwise_distance,
                                              pairwise_distance_torch)
    from repro_torch.kernels.frontier import (frontier_scores,
                                              frontier_scores_torch)

    on_card = device == "cuda"
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
        """Mean ms per call: CUDA events over ``iters`` warm calls."""
        for _ in range(warmup):
            fn()
        if not on_card:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def wall(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    # ---------------------------------------------------------------- 1
    if on_card:
        emit("device", kind=torch.cuda.get_device_name(0),
             count=torch.cuda.device_count(), nvidia_smi=nvidia_smi_line(),
             torch=torch.__version__, cuda=torch.version.cuda)

    # ---------------------------------------------------------------- 2
    if on_card:
        t0 = time.perf_counter()
        secs = _build.build_all()
        total = time.perf_counter() - t0
        ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                        if "registers" in ln or "spill" in ln]
                 for name in secs}
        emit("build", seconds_total=total, seconds=secs, ptxas=ptxas)

    # ---------------------------------------------------------------- 3
    rng = np.random.default_rng(0)
    N, cap, dim = cfg["kernel_N"], cfg["capacity"], cfg["dims"]
    b, F = cfg["kernel_b"], cfg["kernel_F"]
    pages = dict(
        vecs=torch.from_numpy(rng.random((N, cap, dim), np.float32)).to(dev),
        radius=torch.from_numpy(
            np.abs(rng.normal(0, 0.1, (N, cap))).astype(np.float32)).to(dev))
    valid = rng.random((N, cap)) < 0.8
    is_leaf = rng.random(N) < 0.5
    iv = torch.from_numpy(valid & ~is_leaf[:, None]).to(dev)
    lv = torch.from_numpy(valid & is_leaf[:, None]).to(dev)
    fids_np = rng.integers(0, N, (b, F)).astype(np.int32)
    fids_np[rng.random((b, F)) < 0.1] = -1                  # empty slots
    fids = torch.from_numpy(fids_np).to(dev)
    queries = torch.from_numpy(rng.random((b, dim), np.float32)).to(dev)
    qpd_np = np.abs(rng.normal(0.5, 0.3, (b, F))).astype(np.float32)
    qpd_np[fids_np < 0] = np.inf
    filt = dict(
        pdist=torch.from_numpy(
            np.abs(rng.normal(0.5, 0.3, (N, cap))).astype(np.float32)).to(dev),
        qpd=torch.from_numpy(qpd_np).to(dev),
        rq=torch.from_numpy(
            np.abs(rng.normal(0.2, 0.1, b)).astype(np.float32)).to(dev))
    args = (fids, queries, pages["vecs"], pages["radius"], iv, lv)
    frontier_rows = {}
    for metric in ("d_inf", "l2", "l1"):
        for prune in (False, True):
            kw = dict(metric=metric, **(filt if prune else {}))
            got = frontier_scores(*args, **kw)
            want = frontier_scores_torch(*args, **kw)
            sync()
            for name, g, w in zip(("dmax", "score", "leaf_d", "dq"), got, want):
                check(torch.equal(g, w),
                      f"frontier {metric} prune={prune} {name} not bitwise")
            ms = time_ms(lambda: frontier_scores(*args, **kw))
            plain_ms = time_ms(lambda: frontier_scores_torch(*args, **kw), iters=5)
            # the least traffic for this data: each referenced page's
            # radius/validity (+pdist) rows and each live entry's vector
            # read once, the four outputs written once
            live = torch.isfinite(want[0]) | torch.isfinite(want[2])
            n_live = int(live.sum())
            nodes = fids.clamp(min=0).long()
            entry = nodes[:, :, None] * cap + torch.arange(cap, device=dev)
            n_vec_rows = torch.unique(entry[live]).numel()
            n_pages = torch.unique(nodes[fids >= 0]).numel()
            per_page = cap * (4 + 1 + 1 + (4 if prune else 0))
            nbytes = (fids.numel() * 4 + queries.numel() * 4
                      + n_pages * per_page + n_vec_rows * dim * 4
                      + (b * F * 4 + b * 4 if prune else 0)
                      + 4 * b * F * cap * 4)
            nops = n_live * dim * 3 + 4 * b * F * cap
            bms, by = bound(nbytes, nops)
            frontier_rows[(metric, prune)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bytes=nbytes, ops=nops, live_evals=n_live, max_abs_err=0.0)
    emit("kernel_frontier", shapes=dict(b=b, F=F, cap=cap, dim=dim, N=N),
         bitwise=True, results={f"{m}/{'prune' if p else 'plain'}": r
                                for (m, p), r in frontier_rows.items()})

    nq, ne = cfg["dist_nq"], cfg["dist_ne"]
    q = torch.from_numpy(rng.random((nq, dim), np.float32)).to(dev)
    e = torch.from_numpy(rng.random((ne, dim), np.float32)).to(dev)
    libcalls = {
        "d_inf": lambda: torch.cdist(q, e, p=float("inf")),
        "sqeuclidean": lambda: torch.cdist(q, e, p=2.0) ** 2,
        "ip": lambda: -(q @ e.T),
    }
    dist_rows = {}
    for metric in ("d_inf", "sqeuclidean", "ip"):
        got = pairwise_distance(q, e, metric)
        want = pairwise_distance_torch(q, e, metric)
        sync()
        err = float((got - want).abs().max())
        if metric == "d_inf":
            check(torch.equal(got, want), "distance d_inf not bitwise")
        else:
            tol_ok = bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())
            check(tol_ok, f"distance {metric} beyond 1e-5 (max abs err {err})")
        ms = time_ms(lambda: pairwise_distance(q, e, metric))
        plain_ms = time_ms(lambda: pairwise_distance_torch(q, e, metric), iters=5)
        lib_ms = time_ms(libcalls[metric]) if on_card else None
        bms, by = bound((nq * dim + ne * dim + nq * ne) * 4, nq * ne * dim * 3)
        dist_rows[metric] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=bms, bound_by=by, max_abs_err=err)
    emit("kernel_distance", shapes=dict(nq=nq, ne=ne, d=dim), results=dist_rows)
    del pages, iv, lv, filt, args, q, e

    # ---------------------------------------------------------------- 4-5
    # the main path: launch counts are zeroed here and read after phase 5
    frontier_scores.launches = 0
    frontier_scores.pruned_launches = 0
    pairwise_distance.launches = 0

    n = cfg["n"]
    X = clustered(n, dims=dim, seed=0)
    eng, build_s = wall(lambda: SMTreeEngine.build(
        X, capacity=cap, metric="d_inf", device=device))
    t = eng.tree
    emit("build_tree", n=n, dims=dim, capacity=cap, seconds=build_s,
         n_nodes=int(t.n_nodes), max_nodes=t.max_nodes, height=int(t.height))
    Xd = torch.from_numpy(X).to(dev)
    qrng = np.random.default_rng(1)

    def noisy_queries(m):
        rows = qrng.integers(0, n, m)
        return (X[rows] + qrng.normal(0, 0.01, (m, dim))).astype(np.float32)

    # (a) bench geometry
    def launch_counts():
        return dict(frontier=frontier_scores.launches - frontier_scores.pruned_launches,
                    frontier_pruned=frontier_scores.pruned_launches,
                    distance=pairwise_distance.launches)

    def per_call(fn):
        c0 = launch_counts()
        out = fn()
        return out, {k: v - c0[k] for k, v in launch_counts().items()}

    Qa = torch.from_numpy(noisy_queries(cfg["b_bench"])).to(dev)
    _, knn_launches = per_call(lambda: eng.knn(Qa, k=K, max_frontier=BENCH_F))
    times = []
    for _ in range(cfg["timing_reps"]):
        res, s = wall(lambda: eng.knn(Qa, k=K, max_frontier=BENCH_F))
        times.append(s * 1e3)
    bench_times = times
    emit("knn_bench_geometry", b=cfg["b_bench"], k=K, max_frontier=BENCH_F,
         parent_prune=True, ms_per_cohort=times, launches_per_call=knn_launches,
         dist_evals_per_query=float(res.dist_evals.float().mean()),
         page_hits_per_query=float(res.page_hits.float().mean()),
         overflow_share=float(res.overflow.float().mean()))

    # (b) exact geometry, held bitwise against the scan
    Qb = torch.from_numpy(noisy_queries(cfg["b_exact"])).to(dev)
    tried = {}
    for Fx in EXACT_FS:
        res = eng.knn(Qb, k=K, max_frontier=Fx)
        tried[Fx] = float(res.overflow.float().mean())
        if tried[Fx] == 0.0:
            break
    F_exact = Fx
    times = [wall(lambda: eng.knn(Qb, k=K, max_frontier=F_exact))[1] * 1e3
             for _ in range(cfg["timing_reps"])]
    (scan_d, scan_i), scan_launches = per_call(
        lambda: brute_force_knn(Xd, Qb, k=K + 1, metric="d_inf"))

    def check_exact(res, sd, si, ids_of, what):
        ok = ~res.overflow
        check(bool(ok.any()), f"{what}: every row overflowed")
        check(torch.equal(res.dists[ok], sd[ok, :K]),
              f"{what}: dists differ from the scan on non-overflow rows")
        distinct = ok & (sd[:, K - 1] != sd[:, K])
        tree_ids = torch.sort(res.ids[distinct].long(), 1).values
        want_ids = torch.sort(ids_of(si[distinct, :K]), 1).values
        check(torch.equal(tree_ids, want_ids),
              f"{what}: ids differ from the scan where the k-th distance is unique")
        return int(ok.sum()), int(distinct.sum())

    n_ok, n_ids = check_exact(res, scan_d, scan_i, lambda i: i, "exact knn")
    emit("knn_exact_geometry", b=cfg["b_exact"], k=K, overflow_share_by_F=tried,
         max_frontier=F_exact, no_overflow=tried[F_exact] == 0.0,
         ms_per_cohort=times, rows_checked_bitwise=n_ok, rows_ids_checked=n_ids,
         scan_launches_per_call=scan_launches,
         dist_evals_per_query=float(res.dist_evals.float().mean()),
         page_hits_per_query=float(res.page_hits.float().mean()))

    # where a cohort's time goes: device time by kernel under torch.profiler,
    # against the cohort's unprofiled wall time (median of the runs above)
    if on_card:
        from torch.autograd import DeviceType
        prof_rows = {}
        for label, Q, Fx, wall_ms in (("bench", Qa, BENCH_F, bench_times),
                                      ("exact", Qb, F_exact, times)):
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                eng.knn(Q, k=K, max_frontier=Fx)
                torch.cuda.synchronize()
            kern = [ev for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA]
            kern.sort(key=lambda ev: ev.self_device_time_total, reverse=True)
            busy = sum(ev.self_device_time_total for ev in kern) / 1e3
            med = float(np.median(wall_ms))
            prof_rows[label] = dict(
                wall_ms_median=med, device_busy_ms=busy,
                device_idle_share=max(0.0, 1.0 - busy / med),
                kernels=[dict(name=ev.key[:72], ms=ev.self_device_time_total / 1e3,
                              calls=ev.count) for ev in kern[:10]])
        emit("profile_knn", max_frontier={"bench": BENCH_F, "exact": F_exact},
             results=prof_rows)

    # (d) range search against the scan
    radius = 0.02
    rres = eng.range_search(Qb, radius, max_results=128, max_frontier=F_exact)
    D = pairwise_distance(Qb, Xd, "d_inf")
    n_rows = 0
    for r in range(Qb.shape[0]):
        if bool(rres.overflow[r]):
            continue
        got = set(rres.ids[r][rres.ids[r] >= 0].tolist())
        want = set(torch.nonzero(D[r] <= radius).flatten().tolist())
        check(got == want, f"range_search row {r}: {len(got)} ids vs scan {len(want)}")
        n_rows += 1
    emit("range_search", radius=radius, max_results=128, max_frontier=F_exact,
         rows_checked=n_rows,
         mean_hits=float((rres.ids >= 0).float().sum(1).mean()),
         overflow_share=float(rres.overflow.float().mean()))
    del D

    # 5. Insert/Delete: splits from a pile of inserts on one point
    irng = np.random.default_rng(2)
    alive0 = int(t.alive.sum())
    splits = merges = 0
    extra = []
    centre = X[int(irng.integers(n))]

    def track(before):
        nonlocal splits, merges
        after = int(eng.tree.alive.sum())
        splits += max(0, after - before)
        merges += max(0, before - after)
        return after

    alive_now = alive0
    t0 = time.perf_counter()
    for j in range(cfg["n_insert"]):
        if j % 2 == 0:
            x = centre + irng.normal(0, 1e-4, dim)
        else:
            x = X[int(irng.integers(n))] + irng.normal(0, 0.01, dim)
        x = np.clip(x, 0, 1).astype(np.float32)
        eng.insert(x, n + j)
        extra.append(x)
        alive_now = track(alive_now)
    # deletes: thin every leaf child of one parent to min_fill + 1 entries
    # (no underflow), then take two more from one of them — it underflows
    # and its nearest sibling has room, so the two merge; drain three other
    # leaves below min_fill next to full siblings (the union re-splits)
    tr = eng.tree
    counts, oids = tr.count.cpu().numpy(), tr.oid.cpu().numpy()
    childs = tr.child.cpu().numpy()
    leaves = np.nonzero(tr.is_leaf.cpu().numpy() & tr.alive.cpu().numpy())[0]
    mf = tr.min_fill
    p = int(tr.parent[int(leaves[0])])
    check(p >= 0, "the first leaf has no parent")
    kids = childs[p, :counts[p]]
    victims = [o for c in kids for o in oids[c, mf + 1:counts[c]]]
    victims += list(oids[kids[0], :2])
    for nd in leaves[-3:]:
        victims += list(oids[nd, :counts[nd] - mf + 2])
    deleted = set()
    for oid in map(int, victims):
        vec = X[oid] if oid < n else extra[oid - n]
        check(eng.delete(vec, oid), f"delete of {oid} not found")
        deleted.add(oid)
        alive_now = track(alive_now)
    for oid in irng.choice(n, 200, replace=False):
        oid = int(oid)
        if oid in deleted:
            continue
        check(eng.delete(X[oid], oid), f"delete of {oid} not found")
        deleted.add(oid)
        alive_now = track(alive_now)
    check(not eng.delete(X[0] + 5.0, n + cfg["n_insert"] + 7),
          "delete of an absent id reported found")
    mut_s = time.perf_counter() - t0
    check(splits > 0 and merges > 0, f"{splits} node splits, {merges} merges")
    _, val_s = wall(eng.validate)
    n_live = n + cfg["n_insert"] - len(deleted)
    check(eng.n_objects == n_live, f"n_objects {eng.n_objects} != {n_live}")
    Xall = np.vstack([X, np.asarray(extra)])
    keep = np.ones(len(Xall), bool)
    keep[sorted(deleted)] = False
    live_ids = torch.from_numpy(np.nonzero(keep)[0]).to(dev)
    Xlive = torch.from_numpy(Xall[keep]).to(dev)
    Qr = torch.cat([Qb[:cfg["b_recheck"] // 2],
                    torch.from_numpy(np.asarray(extra[:cfg["b_recheck"] // 2])).to(dev)])
    res = eng.knn(Qr, k=K, max_frontier=F_exact)
    sd, si = brute_force_knn(Xlive, Qr, k=K + 1, metric="d_inf")
    n_ok, n_ids = check_exact(res, sd, si, lambda i: live_ids[i], "knn after mutations")
    emit("insert_delete", inserts=cfg["n_insert"], deletes=len(deleted),
         node_splits=splits, node_merges=merges, seconds=mut_s,
         validate_seconds=val_s, validate=True, n_objects=eng.n_objects,
         height=int(eng.tree.height), recheck_rows_bitwise=n_ok,
         recheck_overflow_share=float(res.overflow.float().mean()))

    launches = launch_counts()
    if on_card:
        for name, c in launches.items():
            check(c > 0, f"kernel {name} never launched on the main path")

    # ---------------------------------------------------------------- 6
    def parity(tree, Q, Fx, what):
        h = int(tree.height)
        kw = dict(k=K, F=Fx, height=h, level_stats=True, prune=True)
        a, (bb_a, bp_a) = smtree._knn_cohort(tree, Q, float("inf"), **kw)
        p, (bb_p, bp_p) = smtree._knn_cohort(tree, Q, float("inf"),
                                             scorer=frontier_scores_torch, **kw)
        for f in ("dists", "ids", "page_hits", "dist_evals", "overflow"):
            check(torch.equal(getattr(a, f), getattr(p, f)),
                  f"{what}: kernel and plain paths differ in {f}")
        check(torch.equal(bb_a, bb_p) and torch.equal(bp_a, bp_p),
              f"{what}: level stats differ")
        return dict(b=Q.shape[0], max_frontier=Fx, bitwise=True,
                    overflow_share=float(a.overflow.float().mean()))

    par = {f"d_inf_{n}": parity(eng.tree, Qb[:cfg["b_parity"]], F_exact, "d_inf")}
    del eng, Xd, Xlive
    for metric, seed in (("l2", 2), ("l1", 3)):
        Xs = clustered(cfg["n_small"], dims=dim, seed=seed)
        es = SMTreeEngine.build(Xs, capacity=cap, metric=metric, device=device)
        rows = np.random.default_rng(seed).integers(0, len(Xs), cfg["b_parity"])
        Qs = torch.from_numpy((Xs[rows] + 0.01).astype(np.float32)).to(dev)
        par[f"{metric}_{cfg['n_small']}"] = parity(es.tree, Qs, EXACT_FS[0], metric)
    emit("descent_kernel_vs_plain", results=par)

    d_inf_p = frontier_rows[("d_inf", True)]
    d_inf_u = frontier_rows[("d_inf", False)]
    dd = dist_rows["d_inf"]
    kernels = [
        dict(name="frontier_scores", route="cuda",
             source="src/repro_torch/kernels/csrc/frontier.cu",
             replaces="src/repro/kernels/frontier.py:109",
             launches=launches["frontier"], max_abs_err=0.0, ms=d_inf_u["ms"],
             plain_ms=d_inf_u["plain_ms"], bound_ms=d_inf_u["bound_ms"],
             bound_by=d_inf_u["bound_by"], library_ms=None),
        dict(name="frontier_scores[parent_prune]", route="cuda",
             source="src/repro_torch/kernels/csrc/frontier.cu",
             replaces="src/repro/kernels/frontier.py:121",
             launches=launches["frontier_pruned"], max_abs_err=0.0,
             ms=d_inf_p["ms"], plain_ms=d_inf_p["plain_ms"],
             bound_ms=d_inf_p["bound_ms"], bound_by=d_inf_p["bound_by"],
             library_ms=None),
        dict(name="pairwise_distance", route="cuda",
             source="src/repro_torch/kernels/csrc/distance.cu",
             replaces="src/repro/kernels/distance.py:33",
             launches=launches["distance"], max_abs_err=dd["max_abs_err"],
             ms=dd["ms"], plain_ms=dd["plain_ms"], bound_ms=dd["bound_ms"],
             bound_by=dd["bound_by"], library_ms=dd["library_ms"]),
    ]
    return kernels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    kernels = run(FULL, "cuda")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
