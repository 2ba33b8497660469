#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc; it exits non-zero without them.  It imports only
``repro_torch`` (from ``src/`` beside this file), torch, numpy and the
standard library, and prints one JSON line per phase.

The index slice (``run``):

  1. device: the card's name, the device count and nvidia-smi's name and
     power limit;
  2. build: nvcc build seconds of every source and its -Xptxas -v summary
     (instantiations, registers and spilled bytes of each kernel);
  3. each kernel against its plain PyTorch version at the main path's
     shapes (frontier scorer: bitwise for d_inf/l2/l1, filter off and on;
     distance scan: d_inf bitwise, sqeuclidean/ip within 1e-5, at the
     index path's 256 x 1,000,000 x 20 and at 1024 x 65,536 x 20), with
     CUDA-event times of the kernel, the plain version and the library
     call that computes the same function, where there is one, and the
     kernel's device time (``device_ms``);
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
  5b. frontier_replay_index: the frontiers that one cohort passed to the
     scorer at the bench and the exact geometry (captured through the
     plain scorer in phase 4), replayed level by level through the narrow
     kernel as phase 12 does for the wide one;
  6. the cohort descent through the kernels against the same descent
     through the plain scorer, bitwise (all five result fields and the
     level-stat stacks), on the d_inf tree and on 100k-object l2/l1 trees.

The kNN-LM serving slice (``run_lm``), qwen2.5-3b at full width in f32:

  7. kernel_frontier_wide: the frontier scorer's wide-row variant bitwise
     against the plain version at b=64, F=128, cap=32, dim 2048/896/1023,
     d_inf/l2/l1, filter off and on, timed at dim 2048;
  8. kernel_flash: the flash kernel against ``flash_attention_torch`` at
     the prefill shape [4, 16, 2048, 128] causal (f32 within 2e-4, bf16
     within 1e-2) and at GQA g=8 with sq != sk, causal and not; times of
     the kernel, the plain version and SDPA (the library call, sq == sk),
     and the bound at the arithmetic the kernel uses (three TF32 tensor-core
     products per f32 product, one bf16 product in bf16), beside the f32
     CUDA-core bound (``f32_cuda_core_bound_ms``);
  9. kernel_distance_prune: the distance kernel's prune epilogue against
     its plain version at nq=1024, ne=65,536, d=20, with its device time;
  then the slice's main path, launch counters zeroed just before:
  10. lm_serve: random weights from a seeded generator on the card, one
      prefill forward at b=4, s=2048 through the flash kernel (36 launches)
      held against the same forward through the plain attention, with the
      flash kernel's share of that forward's device time, and the
      ``launch/serve`` loop (b=4, prompt 32, 16 greedy steps) mixing a
      2048-key kNN-LM store; profile_lm: device time by kernel of one
      prefill and one kNN-LM decode step;
  11. knnlm_datastore: 65,536 keys tapped from the model's final hidden
      states (32 x 2048 synthetic tokens), bulk build, retrieval at b=4
      and b=64 (k=8, F=128) with the kernel descent held bitwise against
      the plain-scorer descent, evict_before(1024) through Delete,
      validate(), and the bitwise check again; then the slice's launch
      counts;
  and, outside the counts,
  12. frontier_replay: the frontiers that the descent passed to the scorer
      in the first retrieval at b=4 and b=64 (captured through the plain
      scorer), replayed level by level through the wide kernel, bitwise
      against the plain version: ms (CUDA events around back-to-back
      calls, host overhead included), device ms (CUDA events around calls
      queued behind a spin kernel, so that they run back to back on the
      card: ``device_ms``), live evaluations, pairs, distinct nodes and
      bound for each level and summed over a retrieval.

The last three lines are the ``kernels`` line (every TPU kernel's port,
the frontier scorer's wide rows in two rows of their own: launches on its
slice's main path and per pass of that path, ms, plain ms, bound ms,
library ms; the distance scan at the index path's shape, with its device
ms and its synthetic-shape row),
nvidia-smi's name and power limit, and ``{"ok": true, "device": {...}}``.
Any failed check raises, so the script exits non-zero and prints no
result line.
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
            dist_path_nq=256, dist_path_ne=1_000_000,
            n_insert=300, timing_reps=5)
# the kNN-LM serving slice: qwen2.5-3b at full width (all 36 layers), f32
LM_FULL = dict(
    arch="qwen2.5-3b", smoke=False, prefill_b=4, prefill_s=2048,
    serve_argv=["--knn"],                 # b=4, prompt 32, 16 steps
    ds_seqs=32, ds_len=2048, ds_chunk=4, ds_evict=1024, ret_bs=(4, 64),
    wide_b=64, wide_F=128, wide_cap=32, wide_N=4096, wide_dims=(2048, 896, 1023),
    flash_cases={                         # b, h, hk, sq, sk, d, causal, dtype
        "path_f32": (4, 16, 16, 2048, 2048, 128, True, "float32"),
        "path_bf16": (4, 16, 16, 2048, 2048, 128, True, "bfloat16"),
        "gqa8_sq<sk": (1, 16, 2, 512, 1024, 128, True, "float32"),
        "gqa8_noncausal_sq>sk": (2, 16, 2, 700, 300, 128, False, "float32"),
        "gqa8_bf16": (1, 16, 2, 512, 1024, 128, True, "bfloat16")},
    prune_nq=1024, prune_ne=65_536, prune_d=20, timing_reps=5)
H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12       # f32 outside the tensor cores
H100_TF32_FLOP_PER_S = 495e12     # tensor cores, dense (H100 SXM data sheet)
H100_BF16_FLOP_PER_S = 989e12     # tensor cores, dense (H100 SXM data sheet)


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


def timers(on_card: bool):
    """(sync, time_ms, wall) for the device of the run."""
    import torch

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

    return sync, time_ms, wall


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = nops / H100_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound(nbytes: float, nops: float, dtype: str) -> tuple[float, str]:
    """The flash kernel's bound at the arithmetic it uses: three TF32
    products per f32 product (3xTF32), one bf16 product per bf16 one."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = (3 * nops / H100_TF32_FLOP_PER_S if dtype == "float32"
             else nops / H100_BF16_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(log: str) -> dict:
    """nvcc's ``-Xptxas -v`` output for one source, by kernel: for each
    ``..._kernel`` named in the mangled entry functions, its instantiations,
    the least and most registers any of them uses, the spilled bytes
    (stores and loads) summed over them, and the template arguments of
    those that spill (``spilling``)."""
    import re
    out: dict = {}
    cur = args = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            k = re.search(r"([A-Za-z][A-Za-z_]*kernel)(I(?:L[ib]\d+E)+E)?", m.group(1))
            cur = out.setdefault(k.group(1) if k else m.group(1),
                                 {"instances": 0, "registers": [], "spill_bytes": 0,
                                  "spilling": []})
            cur["instances"] += 1
            args = ("<" + ",".join(re.findall(r"L[ib](\d+)E", k.group(2))) + ">"
                    if k and k.group(2) else "")
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m and int(m.group(1)) + int(m.group(2)):
                cur["spill_bytes"] += int(m.group(1)) + int(m.group(2))
                cur["spilling"].append(args)
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"].append(int(m.group(1)))
    for v in out.values():
        r = v["registers"]
        v["registers"] = [min(r), max(r)] if r else []
    return out


def frontier_traffic(fids, queries, want, cap: int, prune: bool):
    """(bytes, ops, live entries) of one frontier scoring on this data: each
    referenced page's radius/validity (+pdist) rows and each live entry's
    vector read once, the four outputs written once; 3 ops per dimension of
    a live entry and 4 per output slot."""
    import torch
    b, F = fids.shape
    dim = queries.shape[1]
    live = torch.isfinite(want[0]) | torch.isfinite(want[2])
    n_live = int(live.sum())
    nodes = fids.clamp(min=0).long()
    entry = nodes[:, :, None] * cap + torch.arange(cap, device=fids.device)
    n_vec_rows = torch.unique(entry[live]).numel()
    n_pages = torch.unique(nodes[fids >= 0]).numel()
    per_page = cap * (4 + 1 + 1 + (4 if prune else 0))
    nbytes = (fids.numel() * 4 + queries.numel() * 4
              + n_pages * per_page + n_vec_rows * dim * 4
              + (b * F * 4 + b * 4 if prune else 0)
              + 4 * b * F * cap * 4)
    return nbytes, n_live * dim * 3 + 4 * b * F * cap, n_live


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn()``: CUDA events around ``iters`` calls that
    the host enqueues while the stream still runs a ~50 ms spin kernel
    (``torch.cuda._sleep``), so that the calls run back to back on the card.  Free of the host's
    launch overhead, which plain back-to-back event timing of a small
    launch measures instead."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def recorder(calls: list, pages: dict):
    """A scorer that records each call the descent makes (fids, queries,
    metric and the filter inputs) into ``calls`` and the tree arrays into
    ``pages`` (once), then scores through the plain version: no launch."""
    from repro_torch.kernels.frontier import frontier_scores_torch

    def scorer(fids, queries, vecs, radius, iv, lv, *, metric, pdist=None, qpd=None,
               rq=None):
        if "vecs" not in pages:
            pages.update(vecs=vecs.clone(), radius=radius.clone(), iv=iv.clone(),
                         lv=lv.clone())
        if pdist is not None and "pdist" not in pages:
            pages["pdist"] = pdist.clone()
        clone = lambda t: None if t is None else t.clone()
        calls.append(dict(fids=fids.clone(), queries=queries.clone(), metric=metric,
                          pdist=None if pdist is None else pages["pdist"],
                          qpd=clone(qpd), rq=clone(rq)))
        return frontier_scores_torch(fids, queries, vecs, radius, iv, lv, metric=metric,
                                     pdist=pdist, qpd=qpd, rq=rq)
    return scorer


def frontier_replay(captured: dict, pages: dict, on_card: bool):
    """Each captured level through the kernel, bitwise against the plain
    version, timed and bounded (phases 5b and 12, module docstring).
    ``captured`` maps a label to one descent's scorer calls (``recorder``),
    ``pages`` holds the tree arrays they were scored against."""
    import torch

    from repro_torch.kernels.frontier import frontier_scores, frontier_scores_torch
    sync, time_ms, _ = timers(on_card)
    cap = pages["vecs"].shape[1]
    out = {}
    for label, calls in captured.items():
        levels = []
        for c in calls:
            fids = c["fids"]
            filt = {k: c[k] for k in ("pdist", "qpd", "rq") if c[k] is not None}
            args = (fids, c["queries"], pages["vecs"], pages["radius"], pages["iv"],
                    pages["lv"])
            kw = dict(metric=c["metric"], **filt)
            got = frontier_scores(*args, **kw)
            want = frontier_scores_torch(*args, **kw)
            sync()
            for name, g, w in zip(("dmax", "score", "leaf_d", "dq"), got, want):
                check(torch.equal(g, w), f"replayed frontier {label} w={fids.shape[1]} "
                                         f"{name} not bitwise")
            nbytes, nops, n_live = frontier_traffic(fids, c["queries"], want, cap, bool(filt))
            bms, by = bound(nbytes, nops)
            kernel = lambda: frontier_scores(*args, **kw)
            row = dict(w=fids.shape[1], pairs=fids.numel(), prune=bool(filt),
                       distinct_nodes=int(torch.unique(fids[fids >= 0]).numel()),
                       live_evals=n_live, bound_ms=bms, bound_by=by, ms=time_ms(kernel))
            if on_card:
                row.update(device_ms=device_ms(kernel))
            levels.append(row)
            del got, want
        total = {k: sum(r[k] for r in levels) for k in levels[0]
                 if k in ("ms", "device_ms", "bound_ms", "live_evals", "pairs")}
        out[label] = dict(levels=levels, per_descent=total)
    return out


def narrow_frontier_inputs(rng, cfg: dict, dev):
    """The narrow scorer's synthetic geometry (phase 3): b x F slots on
    ``kernel_N`` random pages of ``capacity`` x ``dims`` uniform rows, 10%
    empty slots, 80% valid entries, half the pages leaves.  Returns the
    positional arguments of ``frontier_scores`` and the filter inputs."""
    import numpy as np
    import torch
    N, cap, dim = cfg["kernel_N"], cfg["capacity"], cfg["dims"]
    b, F = cfg["kernel_b"], cfg["kernel_F"]
    t = lambda a: torch.from_numpy(a).to(dev)
    vecs = t(rng.random((N, cap, dim), np.float32))
    radius = t(np.abs(rng.normal(0, 0.1, (N, cap))).astype(np.float32))
    valid = rng.random((N, cap)) < 0.8
    is_leaf = rng.random(N) < 0.5
    iv, lv = t(valid & ~is_leaf[:, None]), t(valid & is_leaf[:, None])
    fids_np = rng.integers(0, N, (b, F)).astype(np.int32)
    fids_np[rng.random((b, F)) < 0.1] = -1                  # empty slots
    queries = t(rng.random((b, dim), np.float32))
    qpd_np = np.abs(rng.normal(0.5, 0.3, (b, F))).astype(np.float32)
    qpd_np[fids_np < 0] = np.inf
    filt = dict(pdist=t(np.abs(rng.normal(0.5, 0.3, (N, cap))).astype(np.float32)),
                qpd=t(qpd_np), rq=t(np.abs(rng.normal(0.2, 0.1, b)).astype(np.float32)))
    return (t(fids_np), queries, vecs, radius, iv, lv), filt


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
    sync, time_ms, wall = timers(on_card)

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
        ptxas = {name: ptxas_summary(_build.build_log(name)) for name in secs}
        emit("build", seconds_total=total, seconds=secs, ptxas=ptxas)

    # ---------------------------------------------------------------- 3
    rng = np.random.default_rng(0)
    dim, cap = cfg["dims"], cfg["capacity"]
    b, F = cfg["kernel_b"], cfg["kernel_F"]
    args, filt = narrow_frontier_inputs(rng, cfg, dev)
    fids, queries = args[:2]
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
            kernel = lambda: frontier_scores(*args, **kw)
            ms = time_ms(kernel)
            plain_ms = time_ms(lambda: frontier_scores_torch(*args, **kw), iters=5)
            nbytes, nops, n_live = frontier_traffic(fids, queries, want, cap, prune)
            bms, by = bound(nbytes, nops)
            frontier_rows[(metric, prune)] = dict(
                ms=ms, device_ms=device_ms(kernel) if on_card else None,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                bytes=nbytes, ops=nops, live_evals=n_live, max_abs_err=0.0)
    emit("kernel_frontier", shapes=dict(b=b, F=F, cap=cap, dim=dim, N=cfg["kernel_N"]),
         bitwise=True, results={f"{m}/{'prune' if p else 'plain'}": r
                                for (m, p), r in frontier_rows.items()})

    dist_rows = {}
    for shape, (nq, ne) in (("path", (cfg["dist_path_nq"], cfg["dist_path_ne"])),
                            ("synthetic", (cfg["dist_nq"], cfg["dist_ne"]))):
        q = torch.from_numpy(rng.random((nq, dim), np.float32)).to(dev)
        e = torch.from_numpy(rng.random((ne, dim), np.float32)).to(dev)
        libcalls = {
            "d_inf": lambda: torch.cdist(q, e, p=float("inf")),
            "sqeuclidean": lambda: torch.cdist(q, e, p=2.0) ** 2,
            "ip": lambda: -(q @ e.T),
        }
        for metric in ("d_inf", "sqeuclidean", "ip"):
            got = pairwise_distance(q, e, metric)
            want = pairwise_distance_torch(q, e, metric)
            sync()
            err = float((got - want).abs().max())
            if metric == "d_inf":
                check(torch.equal(got, want), f"distance {shape} d_inf not bitwise")
            else:
                tol_ok = bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())
                check(tol_ok, f"distance {shape} {metric} beyond 1e-5 (max abs err {err})")
            del got, want
            kernel = lambda: pairwise_distance(q, e, metric)
            ms = time_ms(kernel)
            plain_ms = time_ms(lambda: pairwise_distance_torch(q, e, metric), iters=3,
                               warmup=1)
            lib_ms = time_ms(libcalls[metric], iters=5, warmup=1) if on_card else None
            bms, by = bound((nq * dim + ne * dim + nq * ne) * 4, nq * ne * dim * 3)
            dist_rows[(shape, metric)] = dict(
                ms=ms, device_ms=device_ms(kernel) if on_card else None,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                max_abs_err=err)
        del q, e, libcalls
    emit("kernel_distance",
         shapes=dict(path=dict(nq=cfg["dist_path_nq"], ne=cfg["dist_path_ne"], d=dim),
                     synthetic=dict(nq=cfg["dist_nq"], ne=cfg["dist_ne"], d=dim)),
         results={f"{s}/{m}": r for (s, m), r in dist_rows.items()})
    del filt, args, fids, queries

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
    # the cohort's frontiers as the descent passes them to the scorer,
    # recorded through the plain scorer (no launch) for phase 5b
    index_calls, index_pages = {}, {}
    eng.knn(Qa, k=K, max_frontier=BENCH_F,
            _scorer=recorder(index_calls.setdefault("bench", []), index_pages))
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
    eng.knn(Qb, k=K, max_frontier=F_exact,
            _scorer=recorder(index_calls.setdefault("exact", []), index_pages))
    (scan_d, scan_i), scan_launches = per_call(
        lambda: brute_force_knn(Xd, Qb, k=K + 1, metric="d_inf",
                                device=device))

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
    sd, si = brute_force_knn(Xlive, Qr, k=K + 1, metric="d_inf", device=device)
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

    # ---------------------------------------------------------------- 5b
    replay = frontier_replay(index_calls, index_pages, on_card)
    emit("frontier_replay_index", n=n, dim=dim, metric="d_inf", k=K,
         geometries={"bench": dict(b=cfg["b_bench"], max_frontier=BENCH_F),
                     "exact": dict(b=cfg["b_exact"], max_frontier=F_exact)},
         results=replay)
    del index_calls, index_pages, replay

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
    dd = dist_rows[("path", "d_inf")]
    ds = dist_rows[("synthetic", "d_inf")]
    kernels = [
        dict(name="frontier_scores", route="cuda",
             source="src/repro_torch/kernels/csrc/frontier.cu",
             replaces="src/repro/kernels/frontier.py:109",
             launches=launches["frontier"],
             launches_per_pass={"knn_bench": knn_launches["frontier"]},
             max_abs_err=0.0, ms=d_inf_u["ms"],
             plain_ms=d_inf_u["plain_ms"], bound_ms=d_inf_u["bound_ms"],
             bound_by=d_inf_u["bound_by"], library_ms=None),
        dict(name="frontier_scores[parent_prune]", route="cuda",
             source="src/repro_torch/kernels/csrc/frontier.cu",
             replaces="src/repro/kernels/frontier.py:121",
             launches=launches["frontier_pruned"],
             launches_per_pass={"knn_bench": knn_launches["frontier_pruned"]},
             max_abs_err=0.0,
             ms=d_inf_p["ms"], plain_ms=d_inf_p["plain_ms"],
             bound_ms=d_inf_p["bound_ms"], bound_by=d_inf_p["bound_by"],
             library_ms=None),
        dict(name="pairwise_distance", route="cuda",
             source="src/repro_torch/kernels/csrc/distance.cu",
             replaces="src/repro/kernels/distance.py:33",
             launches=launches["distance"],
             launches_per_pass={"brute_force_knn": scan_launches["distance"]},
             max_abs_err=dd["max_abs_err"], ms=dd["ms"], device_ms=dd["device_ms"],
             plain_ms=dd["plain_ms"], bound_ms=dd["bound_ms"],
             bound_by=dd["bound_by"], library_ms=dd["library_ms"],
             shape=dict(nq=cfg["dist_path_nq"], ne=cfg["dist_path_ne"], d=dim),
             synthetic=dict(nq=cfg["dist_nq"], ne=cfg["dist_ne"], d=dim,
                            **{k: ds[k] for k in ("ms", "device_ms", "plain_ms",
                                                  "bound_ms", "library_ms")})),
    ]
    return kernels


def run_lm(cfg: dict, device: str):
    """The kNN-LM serving slice: its kernels against their plain versions
    (outside the launch counts), then its main path with the counts zeroed
    just before and read just after, then the replayed frontiers.  Returns
    the slice's rows of the ``kernels`` line."""
    import numpy as np
    import torch
    import torch.nn.functional as Fnn

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels.distance import (pairwise_distance_prune,
                                              pairwise_distance_prune_torch)
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_torch)
    from repro_torch.kernels.frontier import (frontier_scores,
                                              frontier_scores_torch)
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models.transformer import hidden_states
    from repro_torch.serve.knnlm import KnnLmConfig, KnnLmDatastore, mix_logits
    from repro_torch.serve.serve_step import make_prefill_step

    on_card = device == "cuda"
    dev = torch.device(device)
    sync, time_ms, wall = timers(on_card)
    gen = torch.Generator(device=dev).manual_seed(7)
    reps = cfg["timing_reps"]

    def free():
        if on_card:
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 7
    # the frontier scorer at wide rows (kNN-LM keys are d_model wide)
    b, F, cap, N = cfg["wide_b"], cfg["wide_F"], cfg["wide_cap"], cfg["wide_N"]
    wide_rows = {}
    for dim in cfg["wide_dims"]:
        vecs = torch.randn((N, cap, dim), generator=gen, device=dev)
        valid = torch.rand((N, cap), generator=gen, device=dev) < 0.8
        leaf = (torch.rand((N,), generator=gen, device=dev) < 0.5)[:, None]
        iv, lv = valid & ~leaf, valid & leaf
        fids = torch.randint(0, N, (b, F), generator=gen, device=dev, dtype=torch.int32)
        fids[torch.rand((b, F), generator=gen, device=dev) < 0.1] = -1
        queries = torch.randn((b, dim), generator=gen, device=dev)
        for metric, scale in (("d_inf", 5.0), ("l2", (2.0 * dim) ** 0.5),
                              ("l1", 1.128 * dim)):
            # radii and parent distances around the metric's distance scale,
            # so the filter keeps some entries and drops others
            u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
            radius = u(N, cap) * 0.05 * scale
            filt = dict(pdist=(1 + 0.15 * torch.randn((N, cap), generator=gen,
                                                      device=dev)).abs() * scale,
                        qpd=(1 + 0.15 * torch.randn((b, F), generator=gen,
                                                    device=dev)).abs() * scale,
                        rq=u(b) * 0.1 * scale)
            args = (fids, queries, vecs, radius, iv, lv)
            for prune in (False, True):
                kw = dict(metric=metric, **(filt if prune else {}))
                got = frontier_scores(*args, **kw)
                want = frontier_scores_torch(*args, **kw)
                sync()
                for name, g, w in zip(("dmax", "score", "leaf_d", "dq"), got, want):
                    check(torch.equal(g, w), f"wide frontier dim={dim} {metric} "
                                             f"prune={prune} {name} not bitwise")
                row = dict(bitwise=True)
                if dim == cfg["wide_dims"][0]:
                    nbytes, nops, n_live = frontier_traffic(fids, queries, want, cap, prune)
                    bms, by = bound(nbytes, nops)
                    row.update(ms=time_ms(lambda: frontier_scores(*args, **kw)),
                               plain_ms=time_ms(lambda: frontier_scores_torch(*args, **kw),
                                                iters=3, warmup=1),
                               bound_ms=bms, bound_by=by, bytes=nbytes, ops=nops,
                               live_evals=n_live)
                wide_rows[f"{dim}/{metric}/{'prune' if prune else 'plain'}"] = row
                del got, want
        del vecs, queries, fids
        free()
    emit("kernel_frontier_wide", shapes=dict(b=b, F=F, cap=cap, N=N,
                                             dims=list(cfg["wide_dims"])),
         bitwise=True, results=wide_rows)

    # ---------------------------------------------------------------- 8
    flash_rows = {}
    for name, (fb, h, hk, sq, sk, d, causal, dt) in cfg["flash_cases"].items():
        dtype = getattr(torch, dt)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(dtype)
        q, k, v = rnd(fb, h, sq, d), rnd(fb, hk, sk, d), rnd(fb, hk, sk, d)
        got = flash_attention_fwd(q, k, v, causal=causal)
        want = flash_attention_torch(q, k, v, causal=causal)
        sync()
        tol = 2e-4 if dt == "float32" else 1e-2
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        check(got.dtype == dtype and got.shape == q.shape, f"flash {name}: dtype/shape")
        check(bool((diff <= tol + tol * want.float().abs()).all()),
              f"flash {name}: beyond {tol} (max abs err {err})")
        row = dict(shape=[fb, h, hk, sq, sk, d], causal=causal, dtype=dt,
                   max_abs_err=err, tol=tol)
        if name.startswith("path"):
            # visible (query, key) pairs, bottom-right causal
            qpos = np.arange(sq) + (sk - sq)
            pairs = int(np.clip(qpos + 1, 0, sk).sum()) if causal else sq * sk
            nops = 4.0 * fb * h * d * pairs
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            bms, by = flash_bound(nbytes, nops, dt)
            row.update(ms=time_ms(lambda: flash_attention_fwd(q, k, v, causal=causal),
                                  iters=10),
                       plain_ms=time_ms(lambda: flash_attention_torch(q, k, v, causal=causal),
                                        iters=3, warmup=1),
                       library_ms=(time_ms(lambda: Fnn.scaled_dot_product_attention(
                           q, k, v, is_causal=causal), iters=10) if on_card else None),
                       bound_ms=bms, bound_by=by,
                       f32_cuda_core_bound_ms=bound(nbytes, nops)[0],
                       flops=nops, bytes=nbytes)
        flash_rows[name] = row
        del q, k, v, got, want, diff
        free()
    emit("kernel_flash", results=flash_rows,
         library="torch.nn.functional.scaled_dot_product_attention (sq == sk only)")

    # ---------------------------------------------------------------- 9
    nq, ne, d = cfg["prune_nq"], cfg["prune_ne"], cfg["prune_d"]
    q = torch.rand((nq, d), generator=gen, device=dev)
    e = torch.rand((ne, d), generator=gen, device=dev)
    prune_rows = {}
    for metric, (lo, hi) in (("d_inf", (0.0, 0.6)),
                             ("sqeuclidean", (0.1 * d ** 0.5, 0.35 * d ** 0.5)),
                             ("ip", (-0.2 * d, -0.05 * d))):
        r_q = lo + (hi - lo) * torch.rand((nq,), generator=gen, device=dev)
        r_e = lo + (hi - lo) * torch.rand((ne,), generator=gen, device=dev)
        gd, gm = pairwise_distance_prune(q, e, r_q, r_e, metric)
        wd, wm = pairwise_distance_prune_torch(q, e, r_q, r_e, metric)
        sync()
        err = float((gd - wd).abs().max())
        check(bool(((gd - wd).abs() <= 1e-5 + 1e-5 * wd.abs()).all()),
              f"prune {metric}: distances beyond 1e-5 (max abs err {err})")
        true_d = wd.clamp_min(0).double().sqrt() if metric == "sqeuclidean" else wd.double()
        decided = (true_d - (r_q[:, None] + r_e[None, :]).double()).abs() > 1e-6
        check(torch.equal(gm[decided], wm[decided]), f"prune {metric}: masks differ")
        bms, by = bound((nq * d + ne * d + nq + ne) * 4 + nq * ne * 5, nq * ne * d * 3)
        kernel = lambda: pairwise_distance_prune(q, e, r_q, r_e, metric)
        prune_rows[metric] = dict(
            ms=time_ms(kernel), device_ms=device_ms(kernel) if on_card else None,
            plain_ms=time_ms(lambda: pairwise_distance_prune_torch(q, e, r_q, r_e, metric),
                             iters=5),
            library_ms=None, bound_ms=bms, bound_by=by, max_abs_err=err,
            undecided=int((~decided).sum()), mask_differs_undecided=int(
                (gm[~decided] != wm[~decided]).sum()),
            survive_share=float(gm.float().mean()))
        del gd, gm, wd, wm, true_d, decided
    emit("kernel_distance_prune", shapes=dict(nq=nq, ne=ne, d=d), results=prune_rows)
    del q, e
    free()

    # ---------------------------------------------------------------- 10-11
    # the main path: counts zeroed here and read after the datastore phase
    frontier_scores.launches = 0
    frontier_scores.pruned_launches = 0
    frontier_scores.wide_launches = 0
    flash_attention_fwd.launches = 0

    def counts():
        return dict(flash=flash_attention_fwd.launches,
                    frontier=frontier_scores.launches,
                    frontier_pruned=frontier_scores.pruned_launches,
                    frontier_wide=frontier_scores.wide_launches)

    def delta(c0):
        return {k: v - c0[k] for k, v in counts().items()}

    mcfg = smoke_config(cfg["arch"]) if cfg["smoke"] else get_config(cfg["arch"])
    params, init_s = wall(lambda: M.init_params(mcfg, 0, device=device))
    n_params = M.param_count(params)
    check(n_params == mcfg.param_count + mcfg.d_model,
          f"{n_params} parameters vs cfg.param_count {mcfg.param_count} "
          "(+ the final norm's scale, which it leaves out)")
    B, S, V = cfg["prefill_b"], cfg["prefill_s"], mcfg.padded_vocab
    tokens = torch.from_numpy(synth_batch(DataConfig(
        vocab_size=mcfg.vocab_size, seq_len=S, global_batch=B), 0,
        with_labels=False)["tokens"]).to(dev)
    prefill = make_prefill_step(mcfg)
    c0 = counts()
    logits, prefill_s = wall(lambda: prefill(params, {"tokens": tokens}))
    per_forward = delta(c0)["flash"]
    if on_card:
        check(per_forward == mcfg.n_layers,
              f"{per_forward} flash launches in one forward, not {mcfg.n_layers}")
    again = [wall(lambda: prefill(params, {"tokens": tokens}))[1] for _ in range(2)]
    plain_logits, plain_s = wall(lambda: make_prefill_step(
        mcfg, _attention=flash_attention_torch)(params, {"tokens": tokens}))
    check(bool(torch.isfinite(logits).all()) and logits.shape == (B, S, V),
          "prefill logits: shape or non-finite values")
    err = float((logits - plain_logits).abs().max())
    top = float(plain_logits.abs().max())
    check(err <= 1e-3 * top, f"prefill logits: kernel vs plain {err} > 1e-3 x {top}")
    argmax_eq = torch.equal(logits[:, -1].argmax(-1), plain_logits[:, -1].argmax(-1))
    check(argmax_eq, "prefill: last-position argmax differs from the plain path")
    del logits, plain_logits
    free()

    # where the time goes: device time by kernel of one prefill forward
    if on_card:
        from torch.autograd import DeviceType

        def profile(fn, wall_ms):
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
            kern = [ev for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA]
            kern.sort(key=lambda ev: ev.self_device_time_total, reverse=True)
            busy = sum(ev.self_device_time_total for ev in kern) / 1e3
            flash = sum(ev.self_device_time_total for ev in kern
                        if "flash_fwd_kernel" in ev.key) / 1e3
            return dict(wall_ms=wall_ms, device_busy_ms=busy,
                        device_idle_share=max(0.0, 1.0 - busy / wall_ms),
                        flash_ms=flash, flash_share_of_busy=flash / busy if busy else 0.0,
                        kernels=[dict(name=ev.key[:72], ms=ev.self_device_time_total / 1e3,
                                      calls=ev.count) for ev in kern[:8]])

        prefill_prof = profile(lambda: prefill(params, {"tokens": tokens}),
                               float(np.median(again)) * 1e3)

    args = serve.parser().parse_args(cfg["serve_argv"] + ["--device", device])
    store, store_s = wall(lambda: serve._build_store(mcfg, args.lam, device))
    c0 = counts()
    toks, timing = serve.serve_loop(args, mcfg, params, store)
    serve_counts = delta(c0)
    check(toks.shape == (args.batch, args.steps + 1)
          and bool(((toks >= 0) & (toks < V)).all()), "serve: bad tokens")
    emit("lm_serve", arch=mcfg.name, n_layers=mcfg.n_layers, d_model=mcfg.d_model,
         heads=[mcfg.n_heads, mcfg.n_kv_heads], d_ff=mcfg.d_ff, vocab=mcfg.vocab_size,
         dtype=mcfg.param_dtype, params=n_params, cfg_param_count=mcfg.param_count,
         init_seconds=init_s,
         prefill=dict(b=B, s=S, ms=[prefill_s * 1e3] + [t * 1e3 for t in again],
                      plain_attention_ms=plain_s * 1e3,
                      flash_launches_per_forward=per_forward,
                      max_abs_logit_err=err, max_abs_logit=top,
                      last_argmax_equal=argmax_eq,
                      flash_share_of_device_time=(prefill_prof["flash_share_of_busy"]
                                                  if on_card else None)),
         serve=dict(batch=args.batch, prompt_len=args.prompt_len, steps=args.steps,
                    knn=True, lam=args.lam, store_keys=len(store.values),
                    store_build_seconds=store_s,
                    prompt_feed_ms_per_token=timing["prefill_s"] * 1e3 / args.prompt_len,
                    ms_per_decode_step=timing["ms_per_step"],
                    frontier_launches_per_step=serve_counts["frontier"] / args.steps,
                    launches=serve_counts, sample=toks[0][:12].tolist()))

    # and of one kNN-LM decode step
    if on_card:
        cache = M.init_cache(mcfg, args.batch, 8, device=device)
        tok = torch.from_numpy(toks[:, 0]).to(dev)

        def decode_knn():
            logits, _ = M.decode_step(params, mcfg, tok, cache, 0)
            h = params.embed[tok.long()].float()
            return mix_logits(logits, store.knn_logits(h, V), args.lam).argmax(-1)

        _, dec_s = wall(decode_knn)
        emit("profile_lm", prefill=prefill_prof,
             decode_step_knn=profile(decode_knn, dec_s * 1e3))
        del cache
    del store, tokens
    free()

    # the datastore: keys are hidden states of 32 x 2048 synthetic tokens
    L, n_seq, chunk = cfg["ds_len"], cfg["ds_seqs"], cfg["ds_chunk"]
    D = mcfg.d_model
    batch = synth_batch(DataConfig(vocab_size=mcfg.vocab_size, seq_len=L,
                                   global_batch=n_seq), 100)
    keys = np.empty((n_seq * L, D), np.float32)
    t0 = time.perf_counter()
    for i in range(0, n_seq, chunk):
        h = hidden_states(params, mcfg, {"tokens": torch.from_numpy(
            batch["tokens"][i:i + chunk]).to(dev)})
        keys[i * L:(i + chunk) * L] = h.reshape(-1, D).cpu().numpy()
    tap_s = time.perf_counter() - t0
    vals = batch["labels"].reshape(-1)
    held = synth_batch(DataConfig(seed=1, vocab_size=mcfg.vocab_size, seq_len=L,
                                  global_batch=chunk), 0)
    hq = hidden_states(params, mcfg, {"tokens": torch.from_numpy(held["tokens"]).to(dev)})
    pick = np.random.default_rng(3).choice(chunk * L, max(cfg["ret_bs"]), replace=False)
    Q = hq.reshape(-1, D)[torch.from_numpy(pick).to(dev)].contiguous()
    del hq
    store = KnnLmDatastore(KnnLmConfig(k=8, lam=0.3, metric="l2", capacity=32,
                                       max_frontier=128), D, device=device)
    _, build_s = wall(lambda: store.build(keys, vals))
    tree = store.engine.tree
    tree_info = dict(keys=len(vals), dim=D, height=int(tree.height),
                     n_nodes=int(tree.n_nodes), max_nodes=tree.max_nodes,
                     page_bytes=tree.vecs.numel() * 4)

    # the first retrieval's frontiers, as the descent passes them to the
    # scorer (through the plain scorer: no launch), for phase 12
    captured, pages = {}, {}

    def retrieval(tag, capture=False):
        out = {}
        for rb in cfg["ret_bs"]:
            q = Q[:rb]
            c0 = counts()
            res = store.retrieve(q)
            launches = delta(c0)
            ref = store.retrieve(q, _scorer=(recorder(captured.setdefault(f"b{rb}", []), pages)
                                             if capture else frontier_scores_torch))
            for f in ("dists", "ids", "page_hits", "dist_evals", "overflow"):
                check(torch.equal(getattr(res, f), getattr(ref, f)),
                      f"datastore {tag} b={rb}: kernel and plain descents differ in {f}")
            ms = [wall(lambda: store.knn_logits(q, V))[1] * 1e3 for _ in range(reps)]
            lp = store.knn_logits(q, V)
            check(lp.shape == (rb, V) and bool(torch.isfinite(lp).all()),
                  f"datastore {tag}: kNN log-probs")
            out[f"b{rb}"] = dict(
                k=8, max_frontier=128, knn_logits_ms=ms, bitwise_vs_plain=True,
                overflow_share=float(res.overflow.float().mean()),
                dist_evals_per_query=float(res.dist_evals.float().mean()),
                page_hits_per_query=float(res.page_hits.float().mean()),
                frontier_launches=launches["frontier"],
                frontier_pruned_launches=launches["frontier_pruned"],
                min_id=int(res.ids.min()))
        return out

    before = retrieval("built", capture=True)
    n_ev = cfg["ds_evict"]
    nodes_before = int(store.engine.tree.alive.sum())
    evicted, evict_s = wall(lambda: store.evict_before(n_ev))
    nodes_after = int(store.engine.tree.alive.sum())
    check(evicted == n_ev, f"evicted {evicted} of {n_ev}")
    _, val_s = wall(store.engine.validate)
    check(store.engine.n_objects == len(vals) - n_ev, "datastore count after eviction")
    after = retrieval("after eviction")
    check(all(r["min_id"] >= n_ev or r["min_id"] == -1 for r in after.values()),
          "an evicted key came back")
    emit("knnlm_datastore", hidden_state_tap_seconds=tap_s, build_seconds=build_s,
         tree=tree_info, retrieval=before, evicted=evicted, evict_seconds=evict_s,
         alive_nodes_before_after_evict=[nodes_before, nodes_after],
         validate=True, validate_seconds=val_s, retrieval_after_evict=after)
    path = counts()
    emit("lm_path_launches", **path)
    if on_card:
        check(path["flash"] > 0, "the flash kernel never launched on the main path")
        check(path["frontier_wide"] > 0 and path["frontier_wide"] == path["frontier"],
              "the wide frontier variant did not carry the datastore's retrieval")
        check(path["frontier_pruned"] > 0 and path["frontier"] > path["frontier_pruned"],
              "the wide frontier ran without or only with the parent filter")
    del store, params, keys
    free()

    # ---------------------------------------------------------------- 12
    replay = frontier_replay(captured, pages, on_card)
    emit("frontier_replay", store_keys=len(vals), k=8, max_frontier=128,
         dim=D, metric="l2", results=replay)
    del captured, pages
    free()

    # every frontier launch of this path is wide (checked above on the card):
    # the unfiltered ones score the root level, the filtered ones the rest
    wide_u = wide_rows[f"{cfg['wide_dims'][0]}/l2/plain"]
    wide_p = wide_rows[f"{cfg['wide_dims'][0]}/l2/prune"]
    ret0 = before[f"b{cfg['ret_bs'][0]}"]
    step_u = (serve_counts["frontier"] - serve_counts["frontier_pruned"]) / args.steps
    step_p = serve_counts["frontier_pruned"] / args.steps
    fl = flash_rows["path_f32"]
    pr = prune_rows["d_inf"]
    return [
        dict(name="frontier_scores[wide]", route="cuda",
             source="src/repro_torch/kernels/csrc/frontier.cu",
             replaces="src/repro/kernels/frontier.py:109",
             launches=path["frontier"] - path["frontier_pruned"],
             launches_per_pass={"decode_step_knn": step_u, "datastore_retrieval":
                                ret0["frontier_launches"] - ret0["frontier_pruned_launches"]},
             max_abs_err=0.0, ms=wide_u["ms"], plain_ms=wide_u["plain_ms"],
             bound_ms=wide_u["bound_ms"], bound_by=wide_u["bound_by"], library_ms=None),
        dict(name="frontier_scores[wide,parent_prune]", route="cuda",
             source="src/repro_torch/kernels/csrc/frontier.cu",
             replaces="src/repro/kernels/frontier.py:121",
             launches=path["frontier_pruned"],
             launches_per_pass={"decode_step_knn": step_p,
                                "datastore_retrieval": ret0["frontier_pruned_launches"]},
             max_abs_err=0.0, ms=wide_p["ms"], plain_ms=wide_p["plain_ms"],
             bound_ms=wide_p["bound_ms"], bound_by=wide_p["bound_by"], library_ms=None),
        dict(name="pairwise_distance_prune", route="cuda",
             source="src/repro_torch/kernels/csrc/distance.cu",
             replaces="src/repro/kernels/distance.py:62",
             launches=0, launches_per_pass={}, max_abs_err=pr["max_abs_err"], ms=pr["ms"],
             device_ms=pr["device_ms"], plain_ms=pr["plain_ms"], bound_ms=pr["bound_ms"],
             bound_by=pr["bound_by"], library_ms=None),
        dict(name="flash_attention_fwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:38",
             launches=path["flash"],
             launches_per_pass={"prefill_forward": per_forward},
             max_abs_err=fl["max_abs_err"], ms=fl["ms"],
             plain_ms=fl["plain_ms"], bound_ms=fl["bound_ms"],
             bound_by=fl["bound_by"], library_ms=fl["library_ms"],
             f32_cuda_core_bound_ms=fl["f32_cuda_core_bound_ms"]),
    ]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    index_rows = run(FULL, "cuda")
    torch.cuda.empty_cache()
    wide, wide_pruned, prune, flash = run_lm(LM_FULL, "cuda")
    kernels = index_rows[:2] + [wide, wide_pruned, index_rows[2], prune, flash]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
