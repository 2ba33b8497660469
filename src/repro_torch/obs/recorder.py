"""Bounded flight recorder: a ring of recent spans + state-transition

A copy of ``repro/obs/recorder.py`` (which imports no JAX): the port keeps
its own, so that it imports nothing of the JAX package.
events, dumped to JSON when something goes wrong.

The ring holds the last ``capacity`` records (spans land here when they
``end()``; events land immediately), so a postmortem dump shows what the
process was doing in the seconds *before* the fault — the classic
flight-recorder contract.  Dump triggers are the replication-plane
faults: ``FencedOut`` (zombie leader writes after losing the lease),
``ShipStall`` (transport made no progress), ``DigestMismatch`` (replica
replay diverged), plus chaos-drill assertions.

Dumps go to ``$REPRO_OBS_DUMP_DIR`` (default: the system temp dir) as
``obs_dump_<reason>_<pid>_<n>.json``; ``last_dump_path`` points at the
most recent one so tests and operators can find it without globbing.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time

__all__ = ["FlightRecorder"]


class FlightRecorder:
    def __init__(self, capacity: int = 4096, *, gate=None):
        self._gate = gate
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._n_spans = 0
        self._n_events = 0
        self._n_dumps = 0
        self.last_dump_path: str | None = None

    @property
    def _on(self) -> bool:
        return self._gate is None or self._gate.on

    # ------------------------------------------------------------- record

    def record_span(self, span) -> None:
        # the span object lands in the ring as-is; to_dict() is deferred
        # to read/dump time (a span is immutable after end(), and the
        # dict build is hot-path cost the serving threads shouldn't pay).
        # No lock: deque.append is atomic under the GIL, and n_spans is
        # a diagnostic where a rare lost increment is acceptable — this
        # runs on every span end, the hottest recorder path.
        if not self._on:
            return
        self._ring.append(span)
        self._n_spans += 1

    def record_event(self, name: str, **attrs) -> None:
        """State transition: lease acquire/fence, degraded flip, shed,
        host escalation, …"""
        if not self._on:
            return
        d = {"kind": "event", "name": name, "t": time.monotonic(),
             "t_wall": time.time(), "attrs": attrs}
        with self._lock:
            self._ring.append(d)
            self._n_events += 1

    def record_fault(self, name: str, exc: BaseException | None = None,
                     **attrs) -> str | None:
        """Record a fault event and dump the ring.  Returns the dump path
        (None when disabled)."""
        if not self._on:
            return None
        if exc is not None:
            attrs = dict(attrs, exc_type=type(exc).__name__, exc=str(exc))
        self.record_event(name, **attrs)
        return self.dump(reason=name)

    # -------------------------------------------------------------- reads

    def records(self) -> list[dict]:
        with self._lock:
            raw = list(self._ring)
        return [r if isinstance(r, dict) else r.to_dict() for r in raw]

    def spans(self) -> list[dict]:
        return [r for r in self.records() if r.get("kind") == "span"]

    def events(self) -> list[dict]:
        return [r for r in self.records() if r.get("kind") == "event"]

    def stats(self) -> dict:
        with self._lock:
            return {"ring_len": len(self._ring), "n_spans": self._n_spans,
                    "n_events": self._n_events, "n_dumps": self._n_dumps}

    # -------------------------------------------------------------- dump

    def _dump_dir(self) -> str:
        return os.environ.get("REPRO_OBS_DUMP_DIR") or tempfile.gettempdir()

    def dump(self, reason: str = "manual", path: str | None = None,
             metrics: dict | None = None) -> str:
        """Write the ring (plus an optional metrics snapshot) as JSON."""
        with self._lock:
            raw = list(self._ring)
            self._n_dumps += 1
            n = self._n_dumps
        records = [r if isinstance(r, dict) else r.to_dict() for r in raw]
        if path is None:
            safe = "".join(c if c.isalnum() or c in "._-" else "_"
                           for c in reason)
            path = os.path.join(
                self._dump_dir(),
                f"obs_dump_{safe}_{os.getpid()}_{n}.json")
        doc = {
            "reason": reason,
            "t_wall": time.time(),
            "pid": os.getpid(),
            "n_records": len(records),
            "records": records,
        }
        if metrics is not None:
            doc["metrics"] = metrics
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=repr)
        os.replace(tmp, path)
        with self._lock:
            self.last_dump_path = path
        return path

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._n_spans = 0
            self._n_events = 0
            self._n_dumps = 0
            self.last_dump_path = None
