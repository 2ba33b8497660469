"""Quickstart: the SM-tree public API in 60 lines (port of
``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--device cpu]

Shows: bulk build -> batched kNN/range queries -> incremental insert ->
DELETE (the paper's contribution) -> invariant validation, and the same
workload on the paper-faithful reference implementation with page-hit (IO)
accounting.  Runs on the card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.engine import SMTreeEngine
from repro_torch.core.ref_impl import SMTree
from repro_torch.data.datagen import clustered


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    # --- data: the paper's clustered distribution ---------------------------
    X = clustered(5000, dims=8, seed=0)
    queries = X[:8] + np.float32(0.01)

    # --- the engine: bulk build + batched queries ---------------------------
    eng = SMTreeEngine.build(X, capacity=32, device=args.device)
    res = eng.knn(queries, k=3, max_frontier=256)
    dists, ids = res.dists.cpu().numpy(), res.ids.cpu().numpy()
    hits = res.page_hits.cpu().numpy()
    print("kNN dists[0]:", dists[0])
    print("kNN ids[0]:  ", ids[0])
    print("page hits/query:", float(hits.mean()))

    rres = eng.range_search(queries, 0.05, max_results=64)
    range0 = sorted(int(i) for i in rres.ids.cpu().numpy()[0] if i >= 0)
    print("range hits[0]:", range0)

    # --- dynamic updates: insert AND delete (the paper's contribution) ------
    def found(x):
        return 99_999 in eng.range_search(x[None], 0.0).ids.cpu().numpy()[0]

    new_pt = np.full(8, 0.5, np.float32)
    eng.insert(new_pt, obj_id=99_999)
    assert found(new_pt)
    assert eng.delete(new_pt, obj_id=99_999)
    assert not found(new_pt)
    eng.validate()   # SM radius invariant, balance, parent pointers, min-fill
    print("insert/delete round-trip OK; invariants hold")

    # --- paper-faithful reference with IO accounting --------------------------
    ref = SMTree(dim=8, capacity=32, n_dims=8)
    for i, x in enumerate(X[:2000]):
        ref.insert(x, i)
    ref.reset_counters()
    nn = ref.knn_query(queries[0], 3)
    print(f"ref kNN (paper DFS order): {[(round(float(d), 4), int(i)) for d, i in nn]} "
          f"in {ref.ios} page hits, {ref.dist_calcs} distance evals")
    ref.reset_counters()
    r0 = ref.range_query(X[0], 0.0)
    print(f"ref R-0 exact-match: {r0} in {ref.ios} page hits "
          f"(paper Fig. 7: far cheaper than NN-1)")
    for i in range(100):
        assert ref.delete(X[i], i)
    ref.validate(check_sm_invariant=True, check_min_fill=True)
    print("ref: 100 deletes, SM invariant + min-fill verified")
    return {"knn_dists": dists.tolist(), "knn_ids": ids.tolist(),
            "page_hits": hits.tolist(), "range_hits0": range0,
            "ref_knn": [[float(d), int(i)] for d, i in nn]}


if __name__ == "__main__":
    main()
