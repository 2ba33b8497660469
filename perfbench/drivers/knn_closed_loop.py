"""Exact kNN serving through the port's front end, by a closed loop of
logical clients.

``clients`` clients each hold one query in flight: a client whose ticket
is answered sends its next query at once.  Queries are objects of the data
set drawn uniformly from ``--seed`` (the paper's query set).  One thread
plays every client: tickets are answered in the order they were admitted
(cohorts take the queue's head), so it waits on the oldest, then takes
every answered ticket in order, stamps it and resubmits.  Each query is
timed by the benchmark from submit to the answer in hand.

After the window: a sample of the window's answers, drawn from the seed,
is held to a brute-force scan of all objects (every distance bit for bit,
every id at its rank's distance).  The loop keeps only every
``check_stride``-th answer (from a seeded offset) for that sample, and a
latency for every query: holding every ticket would give the collector
millions of live objects to walk, and its pauses would land in the
window.
"""
from __future__ import annotations

import collections
import time

import numpy as np

from perfbench import datagen, stats, systems
from perfbench.drivers._common import free_device, frontier_roofline
from perfbench.harness import Check, Outcome
from perfbench.reference import knn as ref


def run(ctx) -> Outcome:
    import torch
    from repro_torch.serve.frontend import FrontendConfig, ServeFrontend, pinned_knn
    from repro_torch.stream import StreamingEngine

    cfg, tr = ctx.config, ctx.traffic
    X, _ = systems.make_objects(cfg, ctx.seed)
    tree = systems.build_index(cfg, X, ctx.device)
    W, C, k, F = tr["cohort_width"], tr["clients"], cfg["k"], cfg["max_frontier"]
    fe = ServeFrontend(StreamingEngine(tree), FrontendConfig(
        cohort_width=W, slo_ms=tr["slo_ms"], k=k, max_frontier=F,
        queue_cap=max(4096, 2 * C)))
    fe.start()
    kept = []                       # every check_stride-th answer: (query row, d, ids)
    lat = []                        # every answer's latency, s
    failed = 0
    try:
        warm = datagen.rng(ctx.seed, "probes").integers(0, len(X), tr["warmup_cohorts"] * W)
        for tk in [fe.submit(X[i]) for i in warm]:
            tk.result(timeout=600)
        qs = datagen.IndexStream(datagen.rng(ctx.seed, "queries"), len(X))
        stride = tr["check_stride"]
        offset = int(datagen.rng(ctx.seed, "sample").integers(stride))
        seq = 0
        win = ctx.open_window(obs_counters=True)
        pending = collections.deque()
        for _ in range(C):
            i = qs.next()
            pending.append((i, time.perf_counter(), fe.submit(X[i])))
        answered_in_window = 0
        while pending:
            tk = pending[0][2]
            try:
                tk.result(timeout=120)
            except Exception:  # noqa: BLE001 — a failed ticket is counted, not fatal
                pass
            now = time.perf_counter()
            if not tk.done():       # never answered: the client gives up on it
                pending.popleft()
                failed += 1
                continue
            while pending and pending[0][2].done():
                i, ts, tk = pending.popleft()
                if tk.err is not None or tk.dists is None:
                    failed += 1
                else:
                    lat.append(now - ts)
                    if seq % stride == offset:
                        kept.append((i, tk.dists, tk.ids))
                    seq += 1
                    if now <= win.t_close:
                        answered_in_window += 1
                if now < win.t_close:
                    j = qs.next()
                    pending.append((j, time.perf_counter(), fe.submit(X[j])))
            win.tick(now)
        win.close(time.perf_counter())
        peak = ctx.memory_peak()
        e2e = {"knn_qps": answered_in_window / ctx.seconds,
               "knn_p95_ms": stats.percentile(lat, 95) * 1e3}
        sources = {}
        if ctx.trace:
            rows = datagen.rng(ctx.seed, "sample").integers(0, len(X), (tr["roofline_cohorts"], W))

            def replay(meter):
                for r in rows:
                    q = torch.from_numpy(X[r]).to(tree.device)
                    pinned_knn(tree, q, k=k, max_frontier=F, _scorer=meter)
            sources["roofline"] = {"narrow": frontier_roofline(
                replay, "frontier_narrow", ctx.on_card)}
        pick = datagen.rng(ctx.seed, "probes").choice(
            len(kept), size=min(tr["check_queries"], len(kept)), replace=False)
        qrows = np.array([kept[p][0] for p in pick])
        got_d = torch.stack([kept[p][1] for p in pick])
        got_i = torch.stack([kept[p][2] for p in pick]).long()
    finally:
        fe.stop(drain=False)
    del fe, tree, kept
    free_device(ctx.on_card)
    Xd = torch.from_numpy(X).to(ctx.device)
    res = ref.compare_answers(Xd, Xd[torch.from_numpy(qrows).to(ctx.device)], got_d, got_i,
                              k, cfg["metric"])
    if ctx.control:     # brute force in bfloat16 in the program's place
        Xb = Xd.bfloat16()
        cd, ci = ref.brute_force(Xb, Xb[torch.from_numpy(qrows).to(ctx.device)], k,
                                 cfg["metric"])
        c = ref.compare_answers(Xd, Xd[torch.from_numpy(qrows).to(ctx.device)], cd.float(),
                                ci, k, cfg["metric"])
        sources["control"] = {"knn_dist_mismatch": c["dist_mismatch"],
                              "knn_id_mismatch": c["id_mismatch"]}
    checks = [Check("knn_dist_mismatch", res["dist_mismatch"], 0),
              Check("knn_id_mismatch", res["id_mismatch"], 0),
              Check("knn_unanswered", failed, 0)]
    return Outcome(e2e=e2e, checks=checks, attempted=len(lat) + failed, failed=failed,
                   memory_peak_bytes=peak, sources=sources)
