"""kNN-LM serving: the SM-tree as a dynamic LM datastore (port of
``repro/serve/knnlm.py``).

Khandelwal et al.-style interpolation: the datastore maps hidden states
h_t -> observed next token; at each decode step the k nearest stored states
are retrieved and mixed

    p(w) = (1 - lam) * p_LM(w) + lam * p_kNN(w),
    p_kNN(w) ∝ Σ_{(h_i, w_i=w)} exp(-d(h, h_i) / T)

The SM-tree makes the datastore *dynamic*: ``evict`` uses the paper's
Delete to drop stale entries online.  Retrieval is the port's cohort
descent (``SMTreeEngine.knn``), whose frontier scorer is the CUDA kernel
on the card; keys are hidden states, so rows are ``d_model`` wide.

``enable_stream`` routes ``add_batch``/``evict_batch`` through the stream
plane (repro_torch.stream): one batched apply per batch, optionally
WAL-logged, with retrieval on a pinned epoch; with ``shards > 1`` the store
becomes a streaming forest.  ``enable_frontend`` puts the serving
front-end in front of the stream (retrieval coalesces into epoch-pinned
cohorts; batches ride its scheduler), and ``enable_replication`` ships the
WAL over a socket to read replicas behind a ``ReplicaRouter``.

With a ``mesh`` (a {data, model} ``DeviceMesh``, launch/mesh.py) the store
is the mesh store: every rank holds the same tree (built from the same
keys, mutated by the same batches), each retrieval runs this rank's rows
of the query cohort (``dist.sharding.query_pspecs``: over the dp axes,
when they divide it) and the results are all-gathered, so every rank gets
the whole cohort's answer, equal to one device's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import SMTreeEngine
from repro_torch.core.smtree import (OP_DELETE, OP_INSERT, ST_APPLIED,
                                     resolve_device)
from repro_torch.models import model as M
from repro_torch.serve.frontend import pinned_knn


@dataclasses.dataclass
class KnnLmConfig:
    k: int = 8
    lam: float = 0.25
    temperature: float = 1.0
    metric: str = "l2"
    capacity: int = 32
    max_frontier: int = 128


class KnnLmDatastore:
    """Datastore over the port's SM-tree engine.  Keys: hidden states [n,
    D]; values: next-token ids [n].  The tree lives on ``device`` (None =
    the card); the oid-indexed key/value history stays on the host, as in
    the reference.  With ``mesh`` set, query cohorts split over its dp
    axes (the mesh store, above)."""

    def __init__(self, cfg: KnnLmConfig, dim: int, mesh=None, *, device=None):
        self.mesh = mesh
        self.cfg = cfg
        self.dim = dim
        self.device = resolve_device(device)
        self.keys = np.zeros((0, dim), np.float32)
        self.values = np.zeros((0,), np.int32)
        self._keys_buf = self.keys
        self._vals_buf = self.values
        self._values_dev = None      # device copy of ``values``, made lazily
        self.engine: SMTreeEngine | None = None
        self.stream = None   # StreamingEngine / StreamingForest when enabled
        self.frontend = None      # serve.frontend.ServeFrontend
        self.ship_server = None   # stream.transport.WalShipServer
        self.replicas = []        # stream.transport.ShippedReplica
        self.router = None        # serve.router.ReplicaRouter

    def build(self, keys: np.ndarray, values: np.ndarray):
        self.keys = np.asarray(keys, np.float32)
        self.values = np.asarray(values, np.int32)
        self._keys_buf = self.keys
        self._vals_buf = self.values
        self._values_dev = None
        self.engine = SMTreeEngine.build(
            self.keys, ids=np.arange(len(self.values)),
            capacity=self.cfg.capacity, metric=self.cfg.metric,
            device=self.device)

    def _no_stream(self, what: str) -> None:
        # the stream publishes engine.tree as an epoch a reader may pin; the
        # engine's Insert/Delete write it in place
        if self.stream is not None:
            raise ValueError(f"{what} writes the tree in place; with the stream "
                             "enabled, use add_batch/evict_batch")

    def add(self, key: np.ndarray, value: int):
        self._no_stream("add")
        oid = len(self.values)
        self._append_history(np.asarray(key, np.float32)[None],
                             np.asarray([value], np.int32))
        self.engine.insert(key, oid)

    def evict(self, oid: int) -> bool:
        """Online deletion — the paper's contribution at work."""
        self._no_stream("evict")
        return self.engine.delete(self.keys[oid], oid)

    def evict_before(self, oid_bound: int) -> int:
        """Sliding-window eviction: drop all entries with id < bound."""
        return sum(self.evict(oid) for oid in range(oid_bound))

    def enable_stream(self, wal_dir: str | None = None, *, shards: int = 0,
                      **kw):
        """Route ``add_batch``/``evict_batch`` through the stream write
        pipeline: conflict-free cohort batching (one batched apply per
        batch instead of one Insert/Delete per entry) with optional WAL
        durability.  Call after ``build``.

        With ``shards`` > 1 the store is re-partitioned round-robin into a
        ``StreamingForest`` (on the store's device) instead of a
        single-tree engine: queries merge per-shard descents, and
        ``maintenance()`` repairs delete skew — incrementally when
        ``rebalance_mode='incremental'`` is passed through ``kw``."""
        from repro_torch.stream import (StreamingEngine, StreamingForest,
                                        WriteAheadLog)
        wal = WriteAheadLog(wal_dir) if wal_dir else None
        if shards and shards > 1:
            if self.mesh is not None:
                raise ValueError(
                    "sharded streaming store is host-side; it does not "
                    "compose with the mesh-replicated query path")
            from repro_torch.core.distributed import build_forest_trees
            trees = build_forest_trees(self.keys, int(shards),
                                       capacity=self.cfg.capacity,
                                       metric=self.cfg.metric,
                                       device=self.device)
            self.stream = StreamingForest(trees, wal=wal, **kw)
        else:
            self.stream = StreamingEngine(self.engine.tree, wal=wal, **kw)
        return self.stream

    def _sync_engine_tree(self) -> None:
        """Point ``engine.tree`` at the *published* epoch (never at the
        batcher's working tree), so non-stream readers of ``engine.tree``
        only see published versions.  A forest's epochs are shard tuples:
        there is no single engine tree, and every read goes through the
        pinned-epoch merge."""
        if self.stream is not None:
            _, tree = self.stream.epochs.current()
            if not isinstance(tree, tuple):
                self.engine.tree = tree

    def enable_frontend(self, **cfg):
        """Serve retrieval through the async front-end: queries coalesce
        into epoch-pinned cohorts, ``add_batch``/``evict_batch`` ride the
        mutation scheduler (applied between epoch publishes) instead of
        stalling the decode loop.  Requires ``enable_stream`` first."""
        if self.stream is None:
            raise ValueError("enable_stream() before enable_frontend()")
        from repro_torch.serve.frontend import FrontendConfig, ServeFrontend
        cfg.setdefault("k", self.cfg.k)
        cfg.setdefault("max_frontier", self.cfg.max_frontier)
        self.frontend = ServeFrontend(self.stream,
                                      FrontendConfig(**cfg)).start()
        return self.frontend

    def close_frontend(self) -> None:
        if self.frontend is not None:
            self.frontend.stop()
            self.frontend = None
            self._sync_engine_tree()

    def enable_replication(self, mirror_root: str, *, n_replicas: int = 1,
                           host: str = "127.0.0.1", seed: int = 0):
        """Fan reads out to ``n_replicas`` socket-fed followers on the
        store's device: a ``WalShipServer`` serves the stream's WAL
        directory, each replica mirrors it locally and replays through the
        identical pipeline, and a ``ReplicaRouter`` in front of the
        front-end routes queries (leader-first; bounded-staleness degraded
        reads if the leader dies).  Requires ``enable_stream(wal_dir=...)``
        — replication is log shipping, there must be a log — and
        ``enable_frontend``.  Followers start from the leader's currently
        *published* epoch and tail from there, so enabling mid-stream is
        safe."""
        if self.stream is None or self.stream.wal is None:
            raise ValueError("enable_stream(wal_dir=...) before "
                             "enable_replication()")
        if not hasattr(self.stream, "batcher"):
            raise ValueError(
                "socket replication here follows single-tree engines; "
                "forest-sharded stores replicate through "
                "stream.replica.Replica over a StreamingForest follower")
        if self.frontend is None:
            raise ValueError("enable_frontend() before enable_replication()")
        import os

        from repro_torch.serve.router import ReplicaRouter
        from repro_torch.stream import StreamingEngine
        from repro_torch.stream.transport import ShippedReplica, WalShipServer
        wal = self.stream.wal
        self.ship_server = WalShipServer(wal.directory, host=host,
                                         wal=wal).start()
        start_seq = wal.next_seq - 1
        _, tree = self.stream.epochs.current()
        for i in range(n_replicas):
            follower = StreamingEngine(
                tree, wal=None, max_batch=self.stream.batcher.max_batch,
                headroom_frac=self.stream.headroom_frac)
            rep = ShippedReplica(
                follower, self.ship_server.address,
                os.path.join(mirror_root, f"replica_{i:02d}"),
                start_seq=start_seq, seed=seed + i)
            self.replicas.append(rep.start())
        self.router = ReplicaRouter(self.frontend, self.replicas,
                                    k=self.cfg.k,
                                    max_frontier=self.cfg.max_frontier)
        return self.router.start()

    def close_replication(self) -> None:
        if self.router is not None:
            self.router.stop()
            self.router = None
        for rep in self.replicas:
            rep.stop()
        self.replicas = []
        if self.ship_server is not None:
            self.ship_server.stop()
            self.ship_server = None

    def _append_history(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Amortised-O(1) append to the oid-indexed key/value history
        (capacity doubling; evicted rows keep their slot)."""
        n, b = len(self.values), len(values)
        cap = len(self._keys_buf)
        if n + b > cap:
            new_cap = max(2 * cap, n + b, 1024)
            kb = np.zeros((new_cap, self.dim), np.float32)
            vb = np.zeros((new_cap,), np.int32)
            kb[:n] = self.keys
            vb[:n] = self.values
            self._keys_buf, self._vals_buf = kb, vb
        self._keys_buf[n:n + b] = keys
        self._vals_buf[n:n + b] = values
        self.keys = self._keys_buf[:n + b]
        self.values = self._vals_buf[:n + b]
        self._values_dev = None

    def add_batch(self, keys: np.ndarray, values: np.ndarray) -> np.ndarray:
        """Insert a batch of (key, next-token) pairs; returns their oids."""
        keys = np.asarray(keys, np.float32)
        values = np.asarray(values, np.int32)
        oids = (len(self.values) + np.arange(len(values))).astype(np.int32)
        self._append_history(keys, values)
        if self.frontend is not None:
            self.frontend.submit_mutations(
                np.full(len(oids), OP_INSERT, np.int32), keys, oids)
            self._sync_engine_tree()
        elif self.stream is not None:
            self.stream.insert_batch(keys, oids)
            self._sync_engine_tree()
        else:
            for k, o in zip(keys, oids):
                self.engine.insert(k, int(o))
        return oids

    def evict_batch(self, oids: np.ndarray) -> int:
        """Batched online eviction; returns the number of entries removed
        (with the front-end on, the number *submitted*: the scheduler
        applies the batch between epoch publishes)."""
        oids = np.asarray(oids, np.int32)
        if self.frontend is not None:
            self.frontend.submit_mutations(
                np.full(len(oids), OP_DELETE, np.int32), self.keys[oids], oids)
            self._sync_engine_tree()
            return len(oids)
        if self.stream is None:
            return sum(self.evict(int(o)) for o in oids)
        res = self.stream.delete_batch(self.keys[oids], oids)
        self._sync_engine_tree()
        return int((res.statuses == ST_APPLIED).sum())

    def knn_logits(self, h, vocab: int) -> torch.Tensor:
        """h: [b, D] query hidden states -> kNN log-probs [b, vocab] f32 on
        the tree's device.

        With the stream enabled the descent runs against a *pinned* epoch
        (``EpochManager.reading``; one tree, or a forest's shards merged by
        ``pinned_knn``), so a writer can publish and retire versions
        without ever touching the tree this query descends.  With the
        front-end on, the ``[b, D]`` block is admitted as b tickets and
        lands in epoch-pinned cohorts beside any other traffic."""
        if self.frontend is not None:
            d, ids = self.frontend.knn(torch.as_tensor(h).float().cpu().numpy())
            d, ids = d.to(self.device), ids.to(self.device)
        else:
            h = torch.as_tensor(h)
            d, ids = self._gather_rows(*self._knn_rows(self.shard_queries(h)), h.shape[0])
        if self._values_dev is None:
            self._values_dev = torch.from_numpy(self.values).to(self.device)
        vals = torch.where(ids >= 0, self._values_dev[ids.clamp_min(0).long()], 0)
        fin = torch.isfinite(d)
        w = torch.softmax(torch.where(fin, -d / self.cfg.temperature, -torch.inf), -1)
        b = d.shape[0]
        probs = torch.zeros((b, vocab), dtype=torch.float32, device=d.device)
        rows = torch.arange(b, device=d.device)[:, None].expand_as(vals)
        probs.index_put_((rows, vals.long()), torch.where(fin, w, 0.0),
                         accumulate=True)
        return torch.log(probs.clamp_min(1e-10))

    def _knn_rows(self, h):
        """The k nearest of each row of ``h`` on this rank's tree (a pinned
        epoch with the stream on)."""
        if self.stream is None:
            res = self.retrieve(h)
            if obs.want_level_stats():      # sampled, as the stream paths
                obs.observe_query_result(res)
            return res.dists, res.ids
        h = torch.as_tensor(h, dtype=torch.float32, device=self.device)
        with self.stream.epochs.reading() as pinned:
            return pinned_knn(pinned, h, k=self.cfg.k, max_frontier=self.cfg.max_frontier)

    def _query_spec(self, b: int):
        from repro_torch.dist.sharding import query_pspecs
        return query_pspecs(self.mesh, b)

    def shard_queries(self, h):
        """This rank's rows of a [b, D] query cohort (``query_pspecs``);
        the whole cohort without a mesh."""
        if self.mesh is None:
            return h
        from repro_torch.dist.sharding import local_slices
        h = torch.as_tensor(h)
        return h[local_slices(self._query_spec(h.shape[0]), tuple(h.shape), self.mesh)]

    def _gather_rows(self, d, ids, b: int):
        """The results of a ``b``-row cohort from every rank's rows (inner
        axis first)."""
        if self.mesh is None:
            return d, ids
        from repro_torch.dist.collectives import all_gather
        from repro_torch.dist.sharding import _axes_of
        for axis in reversed(_axes_of(self._query_spec(b)[0])):
            group = self.mesh.get_group(axis)
            d, ids = all_gather(d, 0, group), all_gather(ids, 0, group)
        return d, ids

    def retrieve(self, h, *, _scorer=None):
        """The k nearest keys of each query (a ``QueryResult``: dists and
        ids [b, k], page hits, evaluations, overflow).  ``_scorer``
        (private) replaces the frontier scorer of the descent, so a caller
        can hold the kernel against the plain version on the card."""
        h = torch.as_tensor(h, dtype=torch.float32, device=self.device)
        return self.engine.knn(h, k=self.cfg.k,
                               max_frontier=self.cfg.max_frontier,
                               _scorer=_scorer)


def mix_logits(lm_logits: torch.Tensor, knn_logp: torch.Tensor, lam: float):
    """log((1-lam) p_LM + lam p_kNN) computed stably."""
    lm_logp = torch.log_softmax(lm_logits.float(), -1)
    return torch.logaddexp(lm_logp + np.log1p(-lam), knn_logp + np.log(lam))


def decode_with_knnlm(params, cfg: ArchConfig, store: KnnLmDatastore,
                      prompt, n_steps: int, *, lam=None):
    """Greedy decode with kNN-LM mixing.  prompt: [b, s0] token ids.  As
    in the reference driver, the query key of a step is the embedding of
    the token fed at that step.  Returns [b, n_steps] int32."""
    lam = lam if lam is not None else store.cfg.lam
    dev = params.embed.device
    prompt = torch.as_tensor(prompt, device=dev)
    b, s0 = prompt.shape
    cache = M.init_cache(cfg, b, s0 + n_steps + 1, device=dev)
    for pos in range(s0):
        logits, cache = M.decode_step(params, cfg, prompt[:, pos], cache, pos)
    out = []
    tok = logits.argmax(-1).to(torch.int32)
    for step in range(n_steps):
        logits, cache = M.decode_step(params, cfg, tok, cache, s0 + step)
        h = params.embed[tok.long()].float()
        mixed = mix_logits(logits, store.knn_logits(h, logits.shape[-1]), lam)
        tok = mixed.argmax(-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1)
