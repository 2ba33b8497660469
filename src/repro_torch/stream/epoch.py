"""Epoch-based snapshot handoff between one writer and many readers.

Port of ``repro/stream/epoch.py``.  The reference's JAX arrays are
immutable; the port's tensors are not, so the writer never writes a tensor
it has published: the batcher copies the tree once per batch before its
first write (stream/batcher.py).  What the epoch layer adds is the
*protocol*: readers (``forest_knn`` cohorts, the kNN-LM serving mixer) pin
the epoch they are querying so the version they hold is never retired out from under a
long-running descent, while the writer keeps advancing the next epoch
through the batcher.  Handoff is O(1) (a dict insert); no copy, no lock on
the data plane (DESIGN.md §10).

    mgr = EpochManager(tree0)
    with mgr.reading() as t:      # reader pins the current version
        ...query t...             # immutable, whatever the writer does
    mgr.publish(new_tree)         # writer hands off the next epoch

(``acquire``/``release`` remain for readers whose pin outlives a single
scope; ``reading()`` is the recommended form — it cannot leak a pin on an
exception mid-descent.)
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any

from repro_torch import obs

__all__ = ["EpochManager"]


class EpochManager:
    """Versioned publish/acquire/release bookkeeping for immutable trees.

    ``keep`` bounds how many *unpinned* superseded versions stay resident
    (0 = only the latest); pinned versions always survive until their last
    reader releases them."""

    def __init__(self, tree: Any, *, epoch: int = 0, keep: int = 0):
        self.keep = int(keep)
        self._lock = threading.Lock()
        self._versions: dict[int, Any] = {epoch: tree}
        self._refs: dict[int, int] = {epoch: 0}
        self._meta: dict[int, Any] = {}
        self._latest = epoch

    # -- reader side -------------------------------------------------------
    @property
    def epoch(self) -> int:
        # locked: an unlocked read can observe _latest mid-publish on
        # another thread (torn against _versions/_refs bookkeeping)
        with self._lock:
            return self._latest

    def current(self) -> tuple[int, Any]:
        """Borrow the latest version without pinning.  Only safe for
        readers that provably finish before the writer's next publish can
        retire it — a long descent over a borrowed tree races
        ``_retire_locked``.  Serving paths should use ``reading()``."""
        with self._lock:
            return self._latest, self._versions[self._latest]

    def acquire(self) -> tuple[int, Any]:
        """Pin and return the latest (epoch, tree)."""
        with self._lock:
            e = self._latest
            self._refs[e] += 1
            return e, self._versions[e]

    @contextlib.contextmanager
    def reading(self, *, with_epoch: bool = False):
        """Context manager over acquire/release: pins the latest version
        for the duration of the block and releases it even on error.

            with mgr.reading() as tree:
                ...query tree...

        ``with_epoch=True`` yields ``(epoch, tree)`` instead — serving
        paths that report which snapshot answered a request (the front-end
        tags every cohort, the replica digest exchange names the epoch it
        verified) need the number without giving up the context-manager
        pin discipline."""
        e, tree = self.acquire()
        try:
            yield (e, tree) if with_epoch else tree
        finally:
            self.release(e)

    def refs(self, epoch: int) -> int:
        """Current pin count for ``epoch`` (diagnostics/tests)."""
        with self._lock:
            return self._refs.get(epoch, 0)

    def release(self, epoch: int) -> None:
        with self._lock:
            if epoch not in self._refs:
                raise KeyError(f"epoch {epoch} was never published")
            if self._refs[epoch] <= 0:
                raise ValueError(f"epoch {epoch} release without acquire")
            self._refs[epoch] -= 1
            self._retire_locked()

    def meta(self, epoch: int) -> Any:
        """Writer-attached provenance for a resident ``epoch`` (``None``
        when the publish carried none, or the version was retired).  The
        streaming forest tags migration-step publishes so diagnostics can
        tell a maintenance epoch from a mutation epoch."""
        with self._lock:
            return self._meta.get(epoch)

    # -- writer side -------------------------------------------------------
    def publish(self, tree: Any, *, meta: Any = None) -> int:
        """Install ``tree`` as the next epoch; returns its number.
        ``meta`` attaches optional provenance retrievable via ``meta()``
        while the version stays resident."""
        with self._lock:
            self._latest += 1
            self._versions[self._latest] = tree
            self._refs[self._latest] = 0
            if meta is not None:
                self._meta[self._latest] = meta
            self._retire_locked()
            latest, resident = self._latest, len(self._versions)
        if obs.enabled():
            obs.counter("epoch.publishes_total").inc()
            obs.gauge("epoch.latest").set(float(latest))
            obs.gauge("epoch.resident").set(float(resident))
        return latest

    # -- retirement --------------------------------------------------------
    def _retire_locked(self) -> None:
        stale = sorted(e for e in self._versions
                       if e != self._latest and self._refs[e] == 0)
        for e in stale[:max(0, len(stale) - self.keep)]:
            del self._versions[e]
            del self._refs[e]
            self._meta.pop(e, None)

    @property
    def resident(self) -> list[int]:
        """Epoch numbers currently held (diagnostics)."""
        with self._lock:
            return sorted(self._versions)
