"""Seeded, deterministic fault injection for the replication plane.

Every recovery path in the transport/lease/router stack must be *exercised*
by tests, not argued for — and a chaos test is only a test when it replays
the same failures bit-for-bit from its seed.  This module is the one source
of injected badness:

  * **frame faults** — ``FaultInjector.filter`` drops / duplicates /
    reorders a response's wire messages, and ``torn`` truncates a data
    chunk's body mid-write (the shipped-segment analogue of a crash
    mid-append).  The transport threads the injector through its send
    path (``stream.transport.WalShipServer(fault=...)``), so the receiver's
    resync machinery — not the happy path — carries the bytes.
  * **timing faults** — ``maybe_delay`` injects bounded latency so
    per-connection timeouts and SLO paths actually fire.
  * **liveness faults** — ``drop_heartbeat`` starves the router's failure
    detector (``serve.router.ReplicaRouter``), forcing degraded mode and
    failover without killing any real thread.
  * **process faults** — kill-and-restart is *not* simulated here: tests
    call the endpoints' real ``stop()``/``start()`` (and the leader's
    ``WriteAheadLog.close``) so recovery runs the genuine resume code.

All draws come from one ``random.Random(seed)`` stream per injector; a
given (seed, call sequence) produces the same fault schedule on every run,
which is what lets CI pin chaos seeds (tests/test_chaos.py) instead of
praying over flakes.

Port of ``repro/stream/faults.py`` (a jax-free module, kept as the port's
own copy): the same plan, the same draws in the same order, so a given
``(seed, call sequence)`` gives the reference's schedule and ``counts``.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time

__all__ = ["FaultPlan", "FaultInjector", "NO_FAULTS"]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Probabilities for each fault class (all off by default).

    ``drop_p``/``dup_p``/``reorder_p`` act per wire message; ``torn_p``
    per data chunk (body truncated to a seeded fraction); ``delay_p``
    sleeps up to ``delay_max_s``; ``heartbeat_drop_p`` acts per heartbeat
    delivery."""
    seed: int = 0
    drop_p: float = 0.0
    dup_p: float = 0.0
    reorder_p: float = 0.0
    torn_p: float = 0.0
    delay_p: float = 0.0
    delay_max_s: float = 0.005
    heartbeat_drop_p: float = 0.0


class FaultInjector:
    """One seeded fault stream (thread-safe: draws are serialized so a
    multi-threaded run still consumes one deterministic sequence)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._rng = random.Random(plan.seed)
        self._lock = threading.Lock()
        self.counts = {"drop": 0, "dup": 0, "reorder": 0, "torn": 0,
                       "delay": 0, "heartbeat_drop": 0}

    def _hit(self, p: float) -> bool:
        with self._lock:
            return p > 0.0 and self._rng.random() < p

    # -- frame faults ------------------------------------------------------
    def filter(self, messages: list) -> list:
        """Apply drop/duplicate/reorder to a list of outgoing wire
        messages.  Reorder swaps adjacent survivors (a bounded shuffle:
        TCP delivers what we send in order, so this models the *shipping
        layer* re-framing, not arbitrary network reordering)."""
        plan = self.plan
        out = []
        for m in messages:
            if self._hit(plan.drop_p):
                self.counts["drop"] += 1
                continue
            out.append(m)
            if self._hit(plan.dup_p):
                self.counts["dup"] += 1
                out.append(m)
        i = 0
        while i + 1 < len(out):
            if self._hit(plan.reorder_p):
                self.counts["reorder"] += 1
                out[i], out[i + 1] = out[i + 1], out[i]
                i += 2          # a swapped pair is settled
            else:
                i += 1
        return out

    def torn(self, body: bytes) -> bytes:
        """Maybe truncate a data chunk mid-write (torn shipped segment).
        Never returns empty for a non-empty body — a zero-byte chunk is
        indistinguishable from no progress and would stall the drill
        rather than exercise the torn-tail scan."""
        if len(body) > 1 and self._hit(self.plan.torn_p):
            self.counts["torn"] += 1
            with self._lock:
                k = self._rng.randint(1, len(body) - 1)
            return body[:k]
        return body

    # -- timing faults -----------------------------------------------------
    def maybe_delay(self) -> None:
        if self._hit(self.plan.delay_p):
            self.counts["delay"] += 1
            with self._lock:
                d = self._rng.uniform(0.0, self.plan.delay_max_s)
            time.sleep(d)

    # -- liveness faults ---------------------------------------------------
    def drop_heartbeat(self) -> bool:
        """True when this heartbeat delivery should be starved."""
        if self._hit(self.plan.heartbeat_drop_p):
            self.counts["heartbeat_drop"] += 1
            return True
        return False


NO_FAULTS = FaultInjector(FaultPlan())
