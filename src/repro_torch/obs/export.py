"""Exposition: `/metrics`-style JSON snapshots, local and over the wire.

The snapshot is one flat JSON object — ``{"metrics": {name: value, …},
"recorder": {…}, "enabled": bool, "t_wall": …}`` — the shape both the
``launch/serve.py --obs`` dump and the ship-server ``{"kind":
"metrics"}`` wire reply use, so one parser serves files, stdout lines,
and sockets.

Port of ``repro/obs/export.py``.  ``fetch_metrics`` speaks the
ship-server's socket protocol (``stream/transport.py``), which the port
does not have yet: it raises ``NotImplementedError`` naming ROADMAP Queue 1
item 11.
"""

from __future__ import annotations

import json
import time

__all__ = ["metrics_snapshot", "render_json", "fetch_metrics",
           "missing_rows"]


def metrics_snapshot() -> dict:
    from repro_torch import obs
    return {
        "enabled": obs.enabled(),
        "t_wall": time.time(),
        "metrics": obs.REGISTRY.snapshot(),
        "recorder": obs.RECORDER.stats(),
    }


def render_json(indent: int | None = None) -> str:
    return json.dumps(metrics_snapshot(), indent=indent, sort_keys=True,
                      default=repr)


def fetch_metrics(address, timeout_s: float = 5.0) -> dict:
    """Pull a metrics snapshot from a running ``WalShipServer``: not ported
    yet (the socket transport, ROADMAP Queue 1 item 11)."""
    raise NotImplementedError(
        "fetch_metrics needs the WAL ship server's socket transport, which "
        "is not ported yet (ROADMAP Queue 1 item 11)")


def missing_rows(snapshot: dict, prefixes) -> list[str]:
    """Which of ``prefixes`` have no metric row in ``snapshot``?  Used by
    the obs-smoke CI assertion ('snapshot covers frontend/router/WAL/
    replica/descent')."""
    metrics = snapshot.get("metrics", {})
    out = []
    for p in prefixes:
        if not any(name.startswith(p) for name in metrics):
            out.append(p)
    return out
