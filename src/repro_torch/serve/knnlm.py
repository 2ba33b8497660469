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

Not ported yet (ROADMAP Queue 1 item 13, each raise naming its part):
the streaming write pipeline (``enable_stream``, 13.1), the serving
front-end and replication (``enable_frontend``, ``enable_replication``,
13.2) and the mesh (13.4).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import SMTreeEngine
from repro_torch.core.smtree import resolve_device
from repro_torch.models import model as M


def _not_ported(what: str, part: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item 13.{part})")


@dataclasses.dataclass
class KnnLmConfig:
    k: int = 8
    lam: float = 0.25
    temperature: float = 1.0
    metric: str = "l2"
    capacity: int = 32
    max_frontier: int = 128


class KnnLmDatastore:
    """Single-device datastore over the port's SM-tree engine.  Keys:
    hidden states [n, D]; values: next-token ids [n].  The tree lives on
    ``device`` (None = the card); the oid-indexed key/value history stays
    on the host, as in the reference."""

    def __init__(self, cfg: KnnLmConfig, dim: int, mesh=None, *, device=None):
        if mesh is not None:
            raise _not_ported("a mesh-sharded datastore", 4)
        self.cfg = cfg
        self.dim = dim
        self.device = resolve_device(device)
        self.keys = np.zeros((0, dim), np.float32)
        self.values = np.zeros((0,), np.int32)
        self._keys_buf = self.keys
        self._vals_buf = self.values
        self._values_dev = None      # device copy of ``values``, made lazily
        self.engine: SMTreeEngine | None = None

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

    def add(self, key: np.ndarray, value: int):
        oid = len(self.values)
        self._append_history(np.asarray(key, np.float32)[None],
                             np.asarray([value], np.int32))
        self.engine.insert(key, oid)

    def evict(self, oid: int) -> bool:
        """Online deletion — the paper's contribution at work."""
        return self.engine.delete(self.keys[oid], oid)

    def evict_before(self, oid_bound: int) -> int:
        """Sliding-window eviction: drop all entries with id < bound."""
        return sum(self.evict(oid) for oid in range(oid_bound))

    def enable_stream(self, *args, **kw):
        raise _not_ported("the streaming write pipeline", 1)

    def enable_frontend(self, **kw):
        raise _not_ported("the serving front-end", 2)

    def enable_replication(self, *args, **kw):
        raise _not_ported("replication", 2)

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
        for k, o in zip(keys, oids):
            self.engine.insert(k, int(o))
        return oids

    def evict_batch(self, oids: np.ndarray) -> int:
        """Batched online eviction; returns the number of entries removed."""
        return sum(self.evict(int(o)) for o in np.asarray(oids, np.int32))

    def knn_logits(self, h, vocab: int) -> torch.Tensor:
        """h: [b, D] query hidden states -> kNN log-probs [b, vocab] f32 on
        the tree's device."""
        res = self.retrieve(h)
        d, ids = res.dists, res.ids
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
