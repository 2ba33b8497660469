"""Exposition: `/metrics`-style JSON snapshots, local and over the wire.

The snapshot is one flat JSON object — ``{"metrics": {name: value, …},
"recorder": {…}, "enabled": bool, "t_wall": …}`` — the shape both the
``launch/serve.py --obs`` dump and the ship-server ``{"kind":
"metrics"}`` wire reply use, so one parser serves files, stdout lines,
and sockets.

Port of ``repro/obs/export.py``.  ``fetch_metrics`` speaks the
ship-server's length-framed protocol (the same socket that serves WAL
pulls, ``stream/transport.py``), so replication deployments get metrics
exposition on a port they already have open.
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
    """Pull a metrics snapshot from a running ``WalShipServer``.

    ``address`` is the ``(host, port)`` the server listens on.  Returns
    the parsed snapshot dict."""
    import socket

    # lazy import: obs must stay importable without the stream package
    from repro_torch.stream import transport as _t

    with socket.create_connection(address, timeout=timeout_s) as conn:
        conn.settimeout(timeout_s)
        _t._send_msg(conn, {"kind": "metrics"})
        header, payload = _t._recv_msg(conn)
        if header.get("kind") != "metrics":
            raise RuntimeError(f"unexpected reply kind {header.get('kind')!r}")
        return json.loads(payload.decode("utf-8"))


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
