#!/usr/bin/env python3
"""Split a kNN-LM decode step's time under each part of the serving plane.

    python3 tools/serve_decode_split.py [VARIANT ...]    # default: all

Runs ``launch/serve``'s own loop (``serve_loop`` with its ``_split`` hook;
qwen2.5-3b at full width, seeded random weights, b=4, prompt 32, 16 greedy
steps, the 2048-key store) under flag sets that add the serving plane one
part at a time: ``--knn``, ``--knn-mutate``, ``--frontend``, ``--frontend
--knn-mutate``, ``--frontend --replicas 2`` and ``--frontend --knn-mutate
--replicas 2``; then the last one three more times: with the replicas'
pumps polling every 50 ms instead of every 5 ms, with the pumps stopped
for the decode loop (the replicas catch up after it), and with the
replicas' followers on the CPU (their pumps and replays make no CUDA
call).

Each step is split into the model's decode step, the kNN-LM mix and the
mutator's submissions, with a synchronize at each boundary.  For each part
``host_ms`` is the decode thread's wall time up to the synchronize,
``cpu_ms`` its CPU time in that span and ``sync_ms`` the wait in the
synchronize.  A part that waits for the interpreter lock grows in
``host_ms`` but not in ``cpu_ms``; one that waits behind other threads'
kernels on the card grows in ``sync_ms``.  Beside them, the CPU time that
the serving plane's threads spend, per step, by thread and by function:
the mirror's frame scans (``_scan_segment`` in the ship client: its resync,
its behind test, its seal), the ship server's responses, the replicas'
polls (``Replica.poll``: the tail scan and the replay) and the engines'
applies (``StreamingEngine.apply``, the leader's and the followers').
A probe thread sleeps 1 ms at a time through the decode loop; how much
longer each sleep takes than asked (``lock_wait_ms``) is the time it
waited to get the interpreter lock back.

First, how many cores the host really gives: the same pure-Python loop
in 1, 2, 4 and 8 processes at once, each one's seconds (``host`` line).
Prints the nvidia-smi line first, then one JSON line a flag set (every
step's parts, their medians, the threads' CPU ms per step, the front-end's
counters).  Needs one CUDA card, like ``chip_smoke.py``.
"""
import collections
import functools
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

MUTATE_REPLICAS = ["--knn", "--knn-mutate", "--frontend", "--replicas", "2"]
VARIANTS = {
    "knn": (["--knn"], None),
    "knn_mutate": (["--knn", "--knn-mutate"], None),
    "frontend": (["--knn", "--frontend"], None),
    "frontend_mutate": (["--knn", "--knn-mutate", "--frontend"], None),
    "frontend_replicas": (["--knn", "--frontend", "--replicas", "2"], None),
    "frontend_mutate_replicas": (MUTATE_REPLICAS, None),
    "frontend_mutate_replicas_pumps_50ms": (MUTATE_REPLICAS, "pumps_50ms"),
    "frontend_mutate_replicas_pumps_stopped": (MUTATE_REPLICAS, "stopped"),
    "frontend_mutate_replicas_cpu_followers": (MUTATE_REPLICAS, "cpu_followers"),
}


def set_replicas(store, mode) -> None:
    """Restart the store's replicas as ``mode`` says (None: as built)."""
    from repro_torch.core.distributed import _to_device
    from repro_torch.stream import StreamingEngine
    for rep in store.replicas if mode is not None else ():
        rep.stop()
        if mode == "cpu_followers":
            # nothing is applied yet: a CPU copy of the follower's tree
            f = rep.replica.follower
            rep.replica.follower = StreamingEngine(
                _to_device(f.tree, "cpu"), max_batch=f.batcher.max_batch,
                headroom_frac=f.headroom_frac)
        if mode != "stopped":
            rep.start(interval=0.05 if mode == "pumps_50ms" else 0.005)


class LockProbe:
    """A thread sleeping 1 ms at a time: each sleep's overshoot is how long
    it waited for the interpreter lock (and the OS scheduler) after it.
    ``waits``: (start on the ``perf_counter`` clock, overshoot ms)."""

    def __init__(self):
        self.waits, self._stop = [], threading.Event()
        self._thread = threading.Thread(target=self._run, name="lock-probe", daemon=True)

    def _run(self):
        while not self._stop.is_set():
            t = time.perf_counter()
            time.sleep(0.001)
            self.waits.append((t, (time.perf_counter() - t - 0.001) * 1e3))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


BUSY_LOOP = ("import time; t = time.perf_counter(); sum(range(30_000_000)); "
             "print(time.perf_counter() - t)")


def host_cores() -> dict:
    """Seconds of ``BUSY_LOOP`` in n processes started together, by n."""
    out = {}
    for n in (1, 2, 4, 8):
        procs = [subprocess.Popen([sys.executable, "-c", BUSY_LOOP], stdout=subprocess.PIPE,
                                  text=True) for _ in range(n)]
        out[n] = [float(p.communicate()[0]) for p in procs]
    return dict(cpu_count=os.cpu_count(), affinity=len(os.sched_getaffinity(0)),
                busy_loop_s=out)


def wrapped_functions(transport, replica, pipeline):
    """(owner, attribute, label) of each function whose CPU time is logged."""
    return [(transport, "_scan_segment", "mirror_scan"),
            (transport.WalShipServer, "_build_response", "ship_response"),
            (replica.Replica, "poll", "replica_poll"),
            (pipeline.StreamingEngine, "apply", "engine_apply")]


class ThreadCpu:
    """Wraps functions to log each call's thread, start time and CPU time
    (``time.thread_time``: the calling thread's own, so a wait for the lock
    costs nothing).  Nested wrapped calls are logged each on its own."""

    def __init__(self):
        self.events = []
        self.lock = threading.Lock()

    def wrap(self, fn, label: str):
        """``fn`` logging each call under ``label``."""
        @functools.wraps(fn)
        def timed(*a, **kw):
            t, cpu = time.perf_counter(), time.thread_time()
            try:
                return fn(*a, **kw)
            finally:
                ev = (t, threading.current_thread().name, label,
                      time.thread_time() - cpu)
                with self.lock:
                    self.events.append(ev)
        return timed

    def per_step(self, starts: list, end: float) -> dict:
        """CPU ms per step by ``thread/function``, over the decode loop."""
        out = collections.Counter()
        for t, thread, label, cpu in self.events:
            if starts[0] <= t < end:
                out[f"{thread}/{label}"] += cpu * 1e3 / len(starts)
        return dict(sorted(out.items()))


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.stream import pipeline, replica, transport

    if not torch.cuda.is_available():
        print("serve_decode_split: no CUDA device available", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    print(json.dumps({"host": host_cores()}), flush=True)
    _build.build_all()
    acct = ThreadCpu()
    for owner, attr, label in wrapped_functions(transport, replica, pipeline):
        setattr(owner, attr, acct.wrap(getattr(owner, attr), label))
    mcfg = get_config("qwen2.5-3b")
    params = M.init_params(mcfg, 0, device="cuda")
    for name in sys.argv[1:] or VARIANTS:
        argv, mode = VARIANTS[name]
        args = serve.parser().parse_args(argv + ["--device", "cuda"])
        store = serve._build_store(args, mcfg, "cuda")
        set_replicas(store, mode)
        acct.events.clear()
        rows = []
        with LockProbe() as probe:
            toks, timing = serve.serve_loop(args, mcfg, params, store, _split=rows)
            end = time.perf_counter()
        threads = acct.per_step([r["start"] for r in rows], end)
        fe = serve._finish_frontend(store, args)
        parts = {p: {k: [r[p][k] for r in rows] for k in rows[0][p]}
                 for p in rows[0] if p != "start"}
        median = {p: {k: float(np.median(v)) for k, v in d.items()} for p, d in parts.items()}
        waits = np.array([w for t, w in probe.waits if t >= rows[0]["start"]])
        lock_wait = dict(n=len(waits), mean=float(waits.mean()),
                         p50=float(np.median(waits)), p90=float(np.percentile(waits, 90)),
                         max=float(waits.max()))
        print(json.dumps({"variant": name, "argv": argv, "replicas": mode,
                          "ms_per_step": timing["ms_per_step"], "parts": parts,
                          "median": median, "thread_cpu_ms_per_step": threads,
                          "lock_wait_ms": lock_wait,
                          "frontend": fe and fe["frontend"],
                          "max_replica_lag": fe and fe["router"] and fe["router"]["max_replica_lag"]}),
              flush=True)
        del store, toks
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
