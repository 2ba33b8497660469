"""The paper's Delete under load: closed-loop submitters of mixed Insert and
Delete tickets through the port's front end, with no queries.

The tickets are one sequence drawn from ``--seed``: ticket ``i`` deletes
``deletes`` ids drawn uniformly from the ids live after tickets ``0 ..
i-1`` and inserts ``inserts`` fresh ids with fresh objects of the same
clustered distribution, its rows in a seeded order.  ``submitters``
threads each hold one ticket in flight; a thread takes the next ticket
and submits it under one lock, so the front end's queue holds the tickets
in sequence order and every delete meets a live id.  The stream writes a
WAL in a directory under ``TMPDIR``; a ticket resolves once its rows are
WAL-appended, applied and published.

The rate counts every row served in the window: the writer serves tickets
one after another, so each ticket's rows count in proportion to the part
of its service inside the window (``stats.interpolated_rate``).

After the window every ticket in flight is waited for, then the published
tree is read back: its live ids and their objects against the reference's
replay of every acknowledged row, and probe kNN queries through the front
end (half at objects inserted during the run) against a brute-force scan
of the replayed live set.
"""
from __future__ import annotations

import shutil
import tempfile
import threading
import time

import numpy as np

from perfbench import datagen, stats, systems
from perfbench.drivers._common import free_device
from perfbench.harness import Check, Outcome
from perfbench.reference import knn as ref


class ChurnPlan:
    """The seeded ticket sequence and the live set it implies."""

    def __init__(self, X, centres, config: dict, traffic: dict, seed: int):
        self.config, self.traffic = config, traffic
        self.n0 = len(X)
        self.centres = centres
        self.fresh_rng = datagen.rng(seed, "fresh")
        self.rng = datagen.rng(seed, "churn")
        self.vecs = [X]                      # rows of object ids, in blocks
        self.n_ids = len(X)
        self.live = np.arange(len(X), dtype=np.int64)
        self.size = len(X)
        self.inserted: list[int] = []

    def _fresh(self, n: int) -> None:
        pts, _ = datagen.clustered(max(n, 65536), dims=self.config["dims"],
                                   n_clusters=self.config["n_clusters"],
                                   spread=self.config["spread"], seed_rng=self.fresh_rng,
                                   centres=self.centres)
        self.vecs.append(pts)

    def all_vecs(self) -> np.ndarray:
        if len(self.vecs) > 1:
            self.vecs = [np.concatenate(self.vecs)]
        return self.vecs[0]

    def next(self):
        """(ops, xs, oids, deleted ids, inserted ids) of the next ticket."""
        from repro_torch.core.smtree import OP_DELETE, OP_INSERT
        nd, ni = self.traffic["deletes"], self.traffic["inserts"]
        pick = self.rng.choice(self.size, size=nd, replace=False)
        dels = self.live[pick].copy()
        for p in sorted(pick.tolist(), reverse=True):    # swap-remove
            self.size -= 1
            self.live[p] = self.live[self.size]
        have = sum(len(v) for v in self.vecs)
        if self.n_ids + ni > have:
            self._fresh(ni)
        ins = np.arange(self.n_ids, self.n_ids + ni, dtype=np.int64)
        self.n_ids += ni
        if self.size + ni > len(self.live):
            self.live = np.concatenate([self.live, np.empty(len(self.live), np.int64)])
        self.live[self.size:self.size + ni] = ins
        self.size += ni
        self.inserted.extend(ins.tolist())
        V = self.all_vecs()
        oids = np.concatenate([dels, ins])
        ops = np.concatenate([np.full(nd, OP_DELETE), np.full(ni, OP_INSERT)])
        order = self.rng.permutation(nd + ni)
        return (ops[order].astype(np.int32), V[oids[order]], oids[order].astype(np.int32),
                dels, ins)


def run(ctx) -> Outcome:
    import torch
    from repro_torch.core.smtree import ST_APPLIED
    from repro_torch.serve.frontend import FrontendConfig, ServeFrontend
    from repro_torch.stream import StreamingEngine, WriteAheadLog

    cfg, tr = ctx.config, ctx.traffic
    X, centres = systems.make_objects(cfg, ctx.seed)
    tree = systems.build_index(cfg, X, ctx.device)
    wal_dir = tempfile.mkdtemp(prefix="perfbench-wal-")
    eng = StreamingEngine(tree, wal=WriteAheadLog(wal_dir))
    k, F = cfg["k"], cfg["max_frontier"]
    fe = ServeFrontend(eng, FrontendConfig(cohort_width=tr["probe_width"], slo_ms=5.0, k=k,
                                           max_frontier=F))
    fe.start()
    plan = ChurnPlan(X, centres, cfg, tr, ctx.seed)
    tickets = []                    # in sequence order: [dels, ins, ticket, t_ack]
    lock = threading.Lock()
    try:
        for _ in range(tr["warmup_tickets"]):
            ops, xs, oids, dels, ins = plan.next()
            fe.submit_mutations(ops, xs, oids).result(timeout=600)
            tickets.append([dels, ins, None, None])
        n_warm = len(tickets)
        win = ctx.open_window(obs_counters=True)

        def submitter():
            while True:
                with lock:
                    if time.perf_counter() >= win.t_close:
                        return
                    ops, xs, oids, dels, ins = plan.next()
                    mt = fe.submit_mutations(ops, xs, oids)
                    slot = [dels, ins, mt, None]
                    tickets.append(slot)
                try:
                    mt.result(timeout=600)
                except Exception:  # noqa: BLE001 — a failed ticket is counted, not fatal
                    pass
                now = time.perf_counter()
                with lock:
                    slot[3] = now
                    win.tick(now)

        threads = [threading.Thread(target=submitter, name=f"perfbench-submit-{i}")
                   for i in range(tr["submitters"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        win.close(time.perf_counter())
        peak = ctx.memory_peak()
        timed = tickets[n_warm:]
        acks, prev = [], win.t_open
        for dels, ins, mt, t_ack in timed:
            prev = max(prev, t_ack)          # served one after another
            acks.append((prev, 0 if mt.err is not None else len(dels) + len(ins)))
        rate = stats.interpolated_rate(acks, win.t_open, win.t_close, win.t_open)
        failed_rows = 0
        acked = [(d, i) for d, i, _, _ in tickets[:n_warm]]
        for dels, ins, mt, _ in timed:
            if mt.err is not None or mt.res is None:
                failed_rows += len(dels) + len(ins)
                continue
            failed_rows += int((mt.res.statuses != ST_APPLIED).sum())
            acked.append((dels, ins))
        # probes: half at objects inserted during the run, half at any live one
        live_ref = ref.replay(np.arange(plan.n0), acked)
        prng = datagen.rng(ctx.seed, "probes")
        ins_live = np.array(sorted(o for o in plan.inserted if o in live_ref), np.int64)
        all_live = np.fromiter(sorted(live_ref), np.int64, len(live_ref))
        n_ins = tr["probe_queries"] // 2 if len(ins_live) else 0
        pr_ids = np.concatenate([ins_live[prng.integers(0, max(1, len(ins_live)), n_ins)],
                                 all_live[prng.integers(0, len(all_live),
                                                        tr["probe_queries"] - n_ins)]])
        V = plan.all_vecs()
        got_d, got_ids = fe.knn(V[pr_ids], timeout=300)
        _, pub = eng.epochs.current()
        live_mask = pub.alive[:, None] & pub.is_leaf[:, None] & pub.valid
        prog_ids = pub.oid[live_mask].cpu().numpy().astype(np.int64)
        prog_vecs = pub.vecs[live_mask].cpu().numpy()
    finally:
        fe.stop(drain=False)
        shutil.rmtree(wal_dir, ignore_errors=True)
    del fe, eng, tree, pub, live_mask
    free_device(ctx.on_card)

    prog_set = set(prog_ids.tolist())
    live_mismatch = len(prog_set ^ live_ref)
    keep = np.isin(prog_ids, all_live)
    vec_mismatch = int((prog_vecs[keep] != V[prog_ids[keep]]).any(1).sum())
    Xl = torch.from_numpy(V[all_live]).to(ctx.device)
    rows = np.searchsorted(all_live, got_ids.numpy().astype(np.int64))
    rows = np.where((rows < len(all_live))
                    & (all_live[np.minimum(rows, len(all_live) - 1)] == got_ids.numpy()), rows, -1)
    res = ref.compare_answers(Xl, torch.from_numpy(V[pr_ids]).to(ctx.device), got_d,
                              torch.from_numpy(rows), k, cfg["metric"])
    extra = {}
    if ctx.control:     # the replay and the probes in bfloat16 in the program's place
        Vb = torch.from_numpy(V[all_live]).bfloat16()
        Qp = torch.from_numpy(V[pr_ids]).to(ctx.device)
        cd, ci = ref.brute_force(Vb.to(ctx.device), Qp.bfloat16(), k, cfg["metric"])
        c = ref.compare_answers(Xl, Qp, cd.float(), ci, k, cfg["metric"])
        vb = Vb.float().numpy()
        extra = {"control": {
            "live_id_mismatch": 0,
            "live_vector_mismatch": int((vb != V[all_live]).any(1).sum()),
            "probe_dist_mismatch": c["dist_mismatch"], "probe_id_mismatch": c["id_mismatch"]}}
    checks = [Check("live_id_mismatch", live_mismatch, 0),
              Check("live_vector_mismatch", vec_mismatch, 0),
              Check("probe_dist_mismatch", res["dist_mismatch"], 0),
              Check("probe_id_mismatch", res["id_mismatch"], 0),
              Check("rows_not_applied", failed_rows, 0)]
    n_rows = sum(len(d) + len(i) for d, i, _, _ in timed)
    return Outcome(e2e={"mutation_rows_per_s": rate}, checks=checks, attempted=n_rows,
                   failed=failed_rows, memory_peak_bytes=peak,
                   sources=extra)
