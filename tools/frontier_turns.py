#!/usr/bin/env python3
"""Time other builds of ``csrc/frontier.cu`` in turns with the current one.

    python3 tools/frontier_turns.py --baseline old=path/to/frontier.cu \
        [--baseline NAME=PATH ...] [--sorted NAME ...]

A one-off comparison for a kernel change: each ``--baseline`` is another
revision of the source with the same C interface (for example one taken with
``git show <commit>:src/repro_torch/kernels/csrc/frontier.cu`` into a
directory git ignores), built with the port's own nvcc flags.  Needs one
CUDA card, like ``chip_smoke.py``, whose helpers it uses.

  1. The narrow kernel at ``chip_smoke.py``'s synthetic geometry (phase 3:
     b=1024, F=64, cap=32, dim 20, 50,000 random nodes) for d_inf, l2 and
     l1, filter off and on, and at level 0's shape (b=1024 pairs on one
     node).
  2. The wide kernel at ``chip_smoke.py``'s synthetic geometry (b=64,
     F=128, cap=32, 4,096 random nodes) at each of ``DIMS`` for l2 (and
     d_inf at dims 2048 and 896), filter off and on, and at level 0's
     shape (b=64 pairs on one node).
  3. ``chip_smoke.main()`` in full, with its replays (phase 5b,
     ``frontier_replay_index``: one index cohort at the bench and the exact
     geometry; phase 12, ``frontier_replay``: one datastore retrieval at
     b=4 and b=64) also timing every replayed level with each build.

Every build is first held bitwise (``torch.equal``) against the plain
version on the same inputs.  Times are taken in turns: the baselines in
the order given, the current kernel twice, the baselines in reverse (for
example old, new, new, old), once as host ms (CUDA events around
back-to-back calls) and once as device ms (``chip_smoke.device_ms``).
``--sorted NAME`` also times build NAME on the launch's pairs sorted by
node id first (``torch.sort`` on the card, the inputs gathered into a
``[b*F, 1]`` frontier and the outputs scattered back: ``sorted_ms``) and
the kernel alone on the sorted inputs (``sorted_kernel_ms``).  Prints one
JSON line per row, among ``chip_smoke.py``'s own lines; the sums over each
replayed descent follow its levels.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the smoke's wide dims (2048, qwen2.5-3b's keys: registers only; 896 and
# 1023: no register level) and two dims whose fold ends in the warp buffer
# after register levels (3072, 4096)
DIMS = (2048, 896, 1023, 3072, 4096)


def build_libs(source: str, baselines: dict[str, Path]) -> dict:
    """Each baseline revision of ``csrc/<source>.cu`` built with the port's
    flags for that source, one nvcc each, in parallel; returns name ->
    (loaded library, nvcc's output with its ``-Xptxas -v`` lines)."""
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in baselines.items():
        so = _build.BUILD_DIR / f"turns-{source}-{name}.so"
        cmd = [_build._nvcc(), *_build.flags(source), "-o", str(so), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {baselines[name]} failed:\n{out[-3000:]}")
        libs[name] = (ctypes.CDLL(str(so)), out)
    return libs


def build(baselines: dict[str, Path]) -> dict:
    """Each baseline ``frontier.cu`` built (``build_libs``); returns name ->
    launcher with ``frontier_scores``' call."""
    import torch

    from repro_torch.kernels.frontier import _METRIC_CODES, _declare
    fns = {}
    for name, (lib, _) in build_libs("frontier", baselines).items():
        lib = _declare(lib)

        def call(fids, queries, vecs, radius, iv, lv, *, metric, pdist=None, qpd=None,
                 rq=None, lib=lib):
            (b, w), (N, cap, dim) = fids.shape, vecs.shape
            outs = [torch.empty((b, w, cap), device=fids.device) for _ in range(4)]
            ptr = lambda t: None if t is None else t.data_ptr()
            rc = lib.frontier_scores_launch(
                ptr(fids), ptr(queries), ptr(vecs), ptr(radius), ptr(iv), ptr(lv),
                ptr(pdist), ptr(qpd), ptr(rq), *(o.data_ptr() for o in outs),
                b, w, N, cap, dim, _METRIC_CODES[metric], int(pdist is not None),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"frontier launch failed: cudaError {rc}")
            return outs
        fns[name] = call
    return fns


def by_node(fn, fids, queries, vecs, radius, iv, lv, *, metric, pdist=None, qpd=None,
            rq=None):
    """``fn`` on the launch's pairs sorted by node id, as a [b*w, 1]
    frontier that carries each pair's query row, outputs put back in the
    launch's order.  Returns (outputs, fn on the sorted inputs alone)."""
    import torch
    b, w = fids.shape
    order = torch.sort(fids.reshape(-1)).indices
    i = order // w
    filt = {} if pdist is None else dict(
        pdist=pdist, qpd=qpd.reshape(-1)[order].reshape(-1, 1).contiguous(),
        rq=rq[i].contiguous())
    args = (fids.reshape(-1)[order].reshape(-1, 1).contiguous(), queries[i].contiguous(),
            vecs, radius, iv, lv)
    outs = []
    for o in fn(*args, metric=metric, **filt):
        back = torch.empty_like(o).reshape(b * w, -1)
        back[order] = o.reshape(b * w, -1)
        outs.append(back.reshape(b, w, -1))
    return outs, lambda: fn(*args, metric=metric, **filt)


class Turns:
    """The timings of one row: every build held bitwise, then timed in turns."""

    def __init__(self, fns: dict, sorted_names: list[str]):
        import chip_smoke
        self.fns, self.sorted_names = fns, sorted_names
        self.time_ms = chip_smoke.timers(True)[1]
        self.device_ms = chip_smoke.device_ms
        base = [n for n in fns if n != "new"]
        self.order = base + ["new", "new"] + base[::-1]

    def __call__(self, args, kw, what: str) -> tuple[dict, tuple]:
        import torch

        from repro_torch.kernels.frontier import frontier_scores_torch
        want = frontier_scores_torch(*args, **kw)
        for name, fn in self.fns.items():
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"{name} not bitwise: {what}")
        row = {}
        for timer, key in ((self.time_ms, "ms"), (self.device_ms, "device_ms")):
            t = [timer(lambda f=self.fns[n]: f(*args, **kw)) for n in self.order]
            row[f"{key}_turns"] = t
            for name in self.fns:
                got = [x for x, n in zip(t, self.order) if n == name]
                row[f"{key}_{name}"] = sum(got) / len(got)
        for name in self.sorted_names:
            srt, kernel = by_node(self.fns[name], *args, **kw)
            if not all(torch.equal(g, w) for g, w in zip(srt, want)):
                raise RuntimeError(f"{name} sorted by node not bitwise: {what}")
            row[f"sorted_ms_{name}"] = self.device_ms(
                lambda: by_node(self.fns[name], *args, **kw))
            row[f"sorted_kernel_ms_{name}"] = self.device_ms(kernel)
        return row, want


def narrow(turns, cfg: dict, device: str):
    """Phase 1 (module docstring) at ``cfg`` (``chip_smoke.FULL``'s keys)."""
    import numpy as np
    import torch

    import chip_smoke
    dev = torch.device(device)
    args, filt = chip_smoke.narrow_frontier_inputs(np.random.default_rng(0), cfg, dev)
    fids, queries = args[:2]
    root = torch.zeros((fids.shape[0], 1), dtype=torch.int32, device=dev)
    cap = cfg["capacity"]
    for geo in ("synthetic", "root"):
        a = args if geo == "synthetic" else (root, *args[1:])
        for metric in ("d_inf", "l2", "l1"):
            for prune in ((False, True) if geo == "synthetic" else (False,)):
                kw = dict(metric=metric, **(filt if prune else {}))
                row, want = turns(a, kw, f"narrow {geo} {metric} prune={prune}")
                nbytes, nops, n_live = chip_smoke.frontier_traffic(a[0], queries, want,
                                                                   cap, prune)
                print(json.dumps(dict(phase="narrow", geo=geo, dim=cfg["dims"],
                                      metric=metric, prune=prune, pairs=a[0].numel(),
                                      live_evals=n_live,
                                      bound_ms=chip_smoke.bound(nbytes, nops)[0], **row)),
                      flush=True)
                del want


def synthetic(turns: Turns):
    """Phase 2 (module docstring)."""
    import torch

    import chip_smoke
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    cfg = chip_smoke.LM_FULL
    b, F, cap, N = cfg["wide_b"], cfg["wide_F"], cfg["wide_cap"], cfg["wide_N"]
    for dim in DIMS:
        vecs = torch.randn((N, cap, dim), generator=gen, device=dev)
        valid = torch.rand((N, cap), generator=gen, device=dev) < 0.8
        leaf = (torch.rand((N,), generator=gen, device=dev) < 0.5)[:, None]
        iv, lv = valid & ~leaf, valid & leaf
        queries = torch.randn((b, dim), generator=gen, device=dev)
        for geo in ("synthetic", "root"):
            if geo == "synthetic":
                fids = torch.randint(0, N, (b, F), generator=gen, device=dev,
                                     dtype=torch.int32)
                fids[torch.rand((b, F), generator=gen, device=dev) < 0.1] = -1
            else:
                fids = torch.zeros((b, 1), device=dev, dtype=torch.int32)
            w = fids.shape[1]
            metrics = ("l2", "d_inf") if dim in (2048, 896) and geo == "synthetic" else ("l2",)
            for metric in metrics:
                scale = 5.0 if metric == "d_inf" else (2.0 * dim) ** 0.5
                u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
                radius = u(N, cap) * 0.05 * scale
                filt = dict(pdist=(1 + 0.15 * torch.randn((N, cap), generator=gen,
                                                          device=dev)).abs() * scale,
                            qpd=(1 + 0.15 * torch.randn((b, w), generator=gen,
                                                        device=dev)).abs() * scale,
                            rq=u(b) * 0.1 * scale)
                args = (fids, queries, vecs, radius, iv, lv)
                for prune in ((False, True) if geo == "synthetic" else (False,)):
                    kw = dict(metric=metric, **(filt if prune else {}))
                    row, want = turns(args, kw, f"{geo} dim={dim} {metric} prune={prune}")
                    nbytes, nops, n_live = chip_smoke.frontier_traffic(fids, queries, want,
                                                                       cap, prune)
                    print(json.dumps(dict(phase="synthetic", geo=geo, dim=dim, metric=metric,
                                          prune=prune, pairs=fids.numel(), live_evals=n_live,
                                          bound_ms=chip_smoke.bound(nbytes, nops)[0], **row)),
                          flush=True)
                    del want
        del vecs, queries
        torch.cuda.empty_cache()


def replaying_in_turns(turns: Turns, replay):
    """``chip_smoke.frontier_replay`` (``replay``), also timing every
    replayed level with each build; the sums over each replayed descent
    follow its levels."""
    def replay_in_turns(captured, pages, on_card):
        out = replay(captured, pages, on_card)
        sums = []
        for label, calls in captured.items():
            total = {}
            for level, c in enumerate(calls):
                filt = {k: c[k] for k in ("pdist", "qpd", "rq") if c[k] is not None}
                args = (c["fids"], c["queries"], pages["vecs"], pages["radius"],
                        pages["iv"], pages["lv"])
                row, _ = turns(args, dict(metric=c["metric"], **filt),
                               f"replay {label} level {level}")
                print(json.dumps(dict(phase="replay", descent=label, b=c["fids"].shape[0],
                                      dim=c["queries"].shape[1], level=level,
                                      w=c["fids"].shape[1], **row)), flush=True)
                for k, v in row.items():
                    if isinstance(v, float):
                        total[k] = total.get(k, 0.0) + v
            sums.append(dict(phase="replay_sum", descent=label,
                             dim=pages["vecs"].shape[2], levels=len(calls), **total))
        for s in sums:
            print(json.dumps(s), flush=True)
        return out
    return replay_in_turns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", action="append", required=True, metavar="NAME=PATH",
                    help="another revision of csrc/frontier.cu (repeatable)")
    ap.add_argument("--sorted", action="append", default=[], metavar="NAME",
                    help="also time this build (or 'new') on pairs sorted by node")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("frontier_turns: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch.kernels.frontier import frontier_scores
    baselines = dict(b.split("=", 1) for b in opts.baseline)
    if "new" in baselines:
        ap.error("'new' names the current kernel")
    fns = {**build({n: Path(p).resolve() for n, p in baselines.items()}),
           "new": frontier_scores}
    turns = Turns(fns, opts.sorted)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    narrow(turns, chip_smoke.FULL, "cuda")
    torch.cuda.empty_cache()
    synthetic(turns)
    torch.cuda.empty_cache()

    chip_smoke.frontier_replay = replaying_in_turns(turns, chip_smoke.frontier_replay)
    return chip_smoke.main()


if __name__ == "__main__":
    sys.exit(main())
