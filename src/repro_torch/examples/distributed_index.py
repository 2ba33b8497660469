"""The SM-forest: build, fan-out query, online delete, the multi-shard form
of the paper's structure (port of ``examples/distributed_index.py``).

    python -m repro_torch.examples.distributed_index [--device cpu]

The JAX example runs the forest on a (2, 4) mesh of 8 host devices.  The
port's forest takes a shard count, not a mesh: its 8 shards are stacked on
one card and searched one after another (``core/distributed.py``).  Runs on
the card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.distributed import (brute_force_knn, build_forest, forest_delete,
                                          forest_knn)
from repro_torch.core.metric import pairwise
from repro_torch.core.smtree import resolve_device
from repro_torch.data.datagen import clustered

SHARDS = 8


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    X = clustered(20_000, dims=12, seed=0)[:, :12].copy()
    Q = X[:32] + np.float32(0.005)

    t0 = time.time()
    forest = build_forest(X, SHARDS, capacity=32, device=dev)
    print(f"forest build over {SHARDS} shards: "
          f"{time.time() - t0:.2f}s ({X.shape[0]} objects)")

    t0 = time.time()
    d, ids = forest_knn(forest, Q, k=5, max_frontier=256)
    sync()
    print(f"forest kNN batch of {len(Q)}: {(time.time() - t0) * 1e3:.1f}ms")

    # exactness vs global brute force
    D = pairwise("d_inf", Q, X)
    dn = d.cpu().numpy()
    np.testing.assert_allclose(dn, np.sort(D, 1)[:, :5], atol=1e-5)
    print("exact vs brute force: OK")

    # the sequential-scan baseline (the paper's horizontal line)
    t0 = time.time()
    d2, _ = brute_force_knn(X, Q, k=5, device=dev)
    sync()
    print(f"brute-force scan: {(time.time() - t0) * 1e3:.1f}ms")

    # online delete over the shards (the paper's contribution, fleet form)
    victims = np.arange(0, 512)
    forest, found = forest_delete(forest, X[victims], victims.astype(np.int32))
    n_found = int(found.sum())
    print(f"distributed delete: {n_found}/512 applied via the fast path")
    _, ids3 = forest_knn(forest, X[:8], k=1, max_frontier=256)
    hit = ids3.cpu().numpy()[:, 0] == np.arange(8)
    print(f"victims still self-matching: {int(hit.sum())}/8 "
          f"(expected ~0 for fast-path deletes)")
    return {"knn_dists": dn.tolist(), "knn_ids": ids.cpu().numpy().tolist(),
            "scan_dists": d2.cpu().numpy().tolist(), "deleted": n_found,
            "after_delete_ids": ids3.cpu().numpy().tolist()}


if __name__ == "__main__":
    main()
