"""Dry run of the distributed SM-forest query step on the production mesh of
H100s (port of ``repro/launch/forest_dryrun.py``): the paper-representative
cell.

    python -m repro_torch.launch.forest_dryrun [--capacity 32] [--frontier 64]
        [--n 262144] [--batch 256] [--k 8] [--tag base] [--batch-axis data]
        [--device cpu]

The 16 shards (one SM-tree per 'model' rank of the 16 x 16 mesh) are built
on the host (``core/distributed.py:build_forest_trees``).  Then rank 0's
real step runs on the card (on the CPU with ``--device cpu``): its shard's
cohort descent through the narrow frontier kernel, then the all-gather of
the candidates over 'model' and the k-way merge, under
``roofline/counts.py:OpCounts``.  A fake process group of 256 ranks stands
for the others (``launch/dryrun.py:fake_world``); its collectives return at
once and write nothing, so the merged result is not one, and the shards'
common height comes from the 16 host-built shards, not from an all-gather.
The rank's local result is held bitwise against the same shard through the
plain scorer.  The record (``artifacts/dryrun_torch/forest_knn__<tag>.json``)
gives the rank's device ms (CUDA events) beside the three roofline terms and
the reference's ``useful_flops``.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import smtree
from repro_torch.core.distributed import _all_gather, _local_knn, _merge_topk, build_forest_trees
from repro_torch.core.smtree import resolve_device
from repro_torch.kernels.frontier import frontier_scores, frontier_scores_torch
from repro_torch.launch.dryrun import ART_DIR, device_mesh, fake_world, roofline
from repro_torch.roofline.counts import OpCounts

N_CHIPS, MESH = 256, (16, 16)
REPS = 10             # steps timed on the card


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=262_144)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=32)
    ap.add_argument("--frontier", type=int, default=64)
    ap.add_argument("--metric", default="l2")
    ap.add_argument("--tag", default="base")
    ap.add_argument("--batch-axis", default=None,
                    help="shard queries over this mesh axis (2D serving)")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--out", default=None, help=f"record directory (default {ART_DIR})")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    n_shards = MESH[1]
    rng = np.random.default_rng(0)
    X = rng.random((args.n, args.dim), np.float32)
    b = args.batch // (MESH[0] if args.batch_axis == "data" else 1)
    Q = torch.from_numpy(rng.random((b, args.dim), np.float32)).to(dev)

    t0 = time.time()
    trees = build_forest_trees(X, n_shards, capacity=args.capacity, metric=args.metric,
                               device=dev)
    build_s = time.time() - t0
    heights = [int(t.height) for t in trees]
    n_nodes = [int(t.n_nodes) for t in trees]
    height = heights[0] if len(set(heights)) == 1 else None
    prune = smtree._resolve_parent_prune(None)
    tree = trees[0]

    def local(scorer=None):
        return _local_knn(tree, Q, args.k, args.frontier, height, prune, scorer)

    with fake_world(N_CHIPS):
        group = device_mesh(*MESH).get_group("model")

        def step():
            r = local()
            return r, _merge_topk(_all_gather(r.dists, group), _all_gather(r.ids, group), args.k)

        c0 = _launches()
        step()                                    # warm: the kernel built and loaded
        rec = OpCounts()
        with rec:
            (got, _), trace_s = _timed(step, on_card)
        device_ms = None
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            for _ in range(REPS):
                step()
            end.record()
            torch.cuda.synchronize()
            device_ms = start.elapsed_time(end) / REPS
        steps = 2 + (REPS if on_card else 0)
        launches = {k: v - c0[k] for k, v in _launches().items()}
        launches["per_step"] = (launches["frontier"] + launches["frontier_pruned"]) / steps
    want = local(frontier_scores_torch)
    fields = ("dists", "ids", "page_hits", "dist_evals", "overflow")
    bitwise = all(torch.equal(getattr(got, f), getattr(want, f)) for f in fields)

    # 'useful' yardstick: the distance evaluations a perfectly pruned search
    # must do: frontier * capacity * levels per query, at 2 * dim flops each
    useful_flops = args.batch * max(heights) * args.frontier * args.capacity \
        * 2 * args.dim / N_CHIPS
    totals = rec.totals()
    rr = roofline(totals, n_chips=N_CHIPS, model_flops_global=useful_flops * N_CHIPS,
                  dtype="float32")
    record = dict(kind="forest_knn", tag=args.tag, n=args.n, dim=args.dim, batch=args.batch,
                  rank_batch=b, k=args.k, capacity=args.capacity, frontier=args.frontier,
                  metric=args.metric, batch_axis=args.batch_axis, device=str(dev),
                  build_s=round(build_s, 2), step_s=trace_s, device_ms=device_ms,
                  n_nodes_per_shard=max(n_nodes), height=max(heights), heights=heights,
                  n_nodes=n_nodes, useful_flops=useful_flops, counts=totals,
                  launches=launches,
                  bitwise_vs_plain=bitwise, **rr)
    out = Path(args.out or ART_DIR)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"forest_knn__{args.tag}.json").write_text(json.dumps(record, indent=1))
    r = rr["roofline"]
    ms = "not measured" if device_ms is None else f"{device_ms:.4f} ms"
    print(f"[forest] tag={args.tag} cap={args.capacity} F={args.frontier}: "
          f"compute {r['compute_s']:.4g}s memory {r['memory_s']:.4g}s "
          f"collective {r['collective_s']:.4g}s bottleneck={r['bottleneck']} "
          f"device {ms} (build {build_s:.0f}s) bitwise={bitwise}", flush=True)
    if not bitwise:
        raise SystemExit("forest dry run: the rank's result differs from the plain scorer's")
    return record


def _launches() -> dict:
    """The frontier kernel's launch counters."""
    f = frontier_scores
    return {"frontier": f.launches - f.pruned_launches, "frontier_pruned": f.pruned_launches,
            "frontier_wide": f.wide_launches}


def _timed(fn, on_card: bool):
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if on_card:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


if __name__ == "__main__":
    main()
