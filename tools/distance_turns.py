#!/usr/bin/env python3
"""Time other builds of ``csrc/distance.cu`` in turns with the current one.

    python3 tools/distance_turns.py --baseline old=path/to/distance.cu \
        [--baseline NAME=PATH ...] [--probe NAME=PATH ...]

A one-off comparison for a kernel change, the sibling of
``tools/frontier_turns.py`` (whose ``build_libs`` it shares): each
``--baseline`` is another revision of the source with the same C interface
(for example one taken with ``git show
<commit>:src/repro_torch/kernels/csrc/distance.cu`` into a directory git
ignores), built with the port's own nvcc flags.  A ``--probe`` is built and
timed the same way but not held against the plain version: a revision
that leaves part of the work out (its stores, say) to show what that part
costs.  Needs one CUDA card, like ``chip_smoke.py``, whose helpers it uses.

  1. For every build: ``-Xptxas -v`` by kernel (``chip_smoke.ptxas_summary``)
     and the opcodes of each kernel's innermost loop that does arithmetic,
     read from ``cuobjdump -sass`` (``sass_loops``).
  2. The scan ``[nq, d] x [ne, d] -> [nq, ne]`` at ``SHAPES`` (the smoke's
     synthetic 1024 x 65,536 x 20 and the index path's 256 x 1,000,000 x
     20) for d_inf, sqeuclidean and ip, and the prune form at the synthetic
     shape, uniform [0, 1) rows as in ``chip_smoke.py``.  Every build is
     first held against the plain version on the same inputs (d_inf
     bitwise, sqeuclidean/ip within 1e-5, prune masks wherever the
     distance is more than 1e-6 from ``r_q + r_e``), then timed in turns:
     the baselines in the order given, the current kernel twice, the
     baselines in reverse, once as host ms (CUDA events around
     back-to-back calls) and once as device ms (``chip_smoke.device_ms``).
     Beside them: the bound and the library call's device ms.
  3. ``brute_force_knn(X, Q, k=11)`` at the path's shape with each build
     in turns (host ms around a synchronised call), and the device ms of
     its two parts: the kernel and the stable sort of the ``[nq, ne]``
     distances.
  4. The card's SM clock and power draw while the current kernel runs
     back to back for ``SUSTAIN_S`` seconds at the path's shape, for each
     metric (``nvidia-smi`` sampled every 100 ms; the median of the
     samples taken while it ran), beside its device ms in that window:
     what converts a time into cycles.

Prints one JSON line per row.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
METRICS = ("d_inf", "sqeuclidean", "ip")
SHAPES = {"synthetic": (1024, 65_536, 20), "path": (256, 1_000_000, 20)}
PRUNE_SHAPES = ("synthetic",)
SUSTAIN_S = 3.0
# prune radii around each metric's distance scale at d (chip_smoke phase 9)
RADII = {"d_inf": lambda d: (0.0, 0.6),
         "sqeuclidean": lambda d: (0.1 * d ** 0.5, 0.35 * d ** 0.5),
         "ip": lambda d: (-0.2 * d, -0.05 * d)}
FP_OPS = ("FADD", "FMNMX", "FFMA", "FMUL")


def parse_sass(text: str) -> dict:
    """``cuobjdump -sass`` output -> {function: innermost arithmetic loop}.

    A loop is the span from a branch's target back to the branch (``BRA
    0x780`` at a later address).  Of the loops that hold no other loop, the
    one with the most FP instructions (``FP_OPS``) is reported: its
    instruction count and its opcodes (the mnemonic without modifiers)
    with their counts."""
    funcs: dict[str, list] = {}
    cur = None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if m and cur is not None:
            ins = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
            cur.append((int(m.group(1), 16), ins))
    out = {}
    for name, ins in funcs.items():
        index = {addr: i for i, (addr, _) in enumerate(ins)}
        loops = []
        for i, (_, s) in enumerate(ins):
            m = re.match(r"BRA(?:\.\w+)*\s+(0x[0-9a-f]+)", s)
            if m and index.get(int(m.group(1), 16), i + 1) <= i:
                loops.append((index[int(m.group(1), 16)], i))
        inner = [(a, b) for a, b in loops
                 if not any(a <= c and d <= b and (c, d) != (a, b) for c, d in loops)]
        best = None
        for a, b in inner:
            ops: dict[str, int] = {}
            for _, s in ins[a:b + 1]:
                op = s.split()[0].split(".")[0]
                ops[op] = ops.get(op, 0) + 1
            fp = sum(ops.get(o, 0) for o in FP_OPS)
            if fp and (best is None or fp > best["fp"]):
                best = dict(instructions=b - a + 1, fp=fp,
                            opcodes=dict(sorted(ops.items(), key=lambda kv: -kv[1])))
        if best is not None:
            out[name] = best
    return out


def sass_loops(so: Path) -> dict:
    """``parse_sass`` of a built library, by kernel instantiation (the
    template arguments of ``dist_kernel``)."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    named = {}
    for fn, loop in parse_sass(text).items():
        m = re.search(r"(\w*kernel)I((?:L[ib]\d+E)+)E", fn)
        key = (m.group(1) + "<" + ",".join(re.findall(r"L[ib](\d+)E", m.group(2))) + ">"
               if m else fn)
        named[key] = loop
    return named


def inputs(nq: int, ne: int, d: int, dev, seed: int = 0):
    """Uniform [0, 1) rows, as ``chip_smoke.py`` draws them."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(rng.random((nq, d), np.float32)), t(rng.random((ne, d), np.float32))


def radii(nq: int, ne: int, d: int, metric: str, dev, seed: int = 1):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    lo, hi = RADII[metric](d)
    return (torch.from_numpy(rng.uniform(lo, hi, nq).astype(np.float32)).to(dev),
            torch.from_numpy(rng.uniform(lo, hi, ne).astype(np.float32)).to(dev))


def check_against_plain(got, want, metric: str, what: str, rq=None, re_=None):
    """The smoke's checks (module docstring, 2): raises on a miss; returns
    the largest absolute distance error."""
    import torch
    gd, gm = got
    if rq is None:
        wd, wm = want, None
    else:
        wd, wm = want
    err = float((gd - wd).abs().max())
    if metric == "d_inf" and rq is None:
        if not torch.equal(gd, wd):
            raise RuntimeError(f"{what}: d_inf not bitwise")
    elif not bool(((gd - wd).abs() <= 1e-5 + 1e-5 * wd.abs()).all()):
        raise RuntimeError(f"{what}: beyond 1e-5 (max abs err {err})")
    if rq is not None:
        true_d = wd.clamp_min(0).double().sqrt() if metric == "sqeuclidean" else wd.double()
        decided = (true_d - (rq[:, None] + re_[None, :]).double()).abs() > 1e-6
        if not torch.equal(gm[decided], wm[decided]):
            raise RuntimeError(f"{what}: prune masks differ")
    return err


def in_turns(fns: dict, call, order: list[str], on_card: bool = True) -> dict:
    """Host ms and device ms of ``call(fn)`` for every build, in turns."""
    import chip_smoke
    time_ms = chip_smoke.timers(on_card)[1]
    row = {}
    for timer, key in ((time_ms, "ms"), (chip_smoke.device_ms, "device_ms")):
        t = [timer(lambda f=fns[n]: call(f)) for n in order]
        row[f"{key}_turns"] = t
        for name in fns:
            got = [x for x, n in zip(t, order) if n == name]
            row[f"{key}_{name}"] = sum(got) / len(got)
    return row


def scan_rows(fns: dict, order: list[str], dev, probes: frozenset = frozenset()):
    """Phase 2 (module docstring); ``probes`` are timed but not checked."""
    import torch

    import chip_smoke
    from repro_torch.kernels.distance import (pairwise_distance_prune_torch,
                                              pairwise_distance_torch)
    on_card = dev.type == "cuda"
    sync = chip_smoke.timers(on_card)[0]
    free = torch.cuda.empty_cache if on_card else (lambda: None)
    for shape, (nq, ne, d) in SHAPES.items():
        q, e = inputs(nq, ne, d, dev)
        lib = {"d_inf": lambda: torch.cdist(q, e, p=float("inf")),
               "sqeuclidean": lambda: torch.cdist(q, e, p=2.0) ** 2,
               "ip": lambda: -(q @ e.T)}
        for prune in ((False, True) if shape in PRUNE_SHAPES else (False,)):
            for metric in METRICS:
                rq = re_ = None
                if prune:
                    rq, re_ = radii(nq, ne, d, metric, dev)
                    want = pairwise_distance_prune_torch(q, e, rq, re_, metric)
                else:
                    want = pairwise_distance_torch(q, e, metric)
                what = f"{shape} {metric} prune={prune}"
                err = {n: check_against_plain(f(q, e, metric, rq, re_), want, metric,
                                              f"{n} {what}", rq, re_)
                       for n, f in fns.items() if n not in probes}
                del want
                sync()
                row = in_turns(fns, lambda f: f(q, e, metric, rq, re_), order, on_card)
                nbytes = (nq * d + ne * d + nq * ne) * 4
                if prune:
                    nbytes += (nq + ne) * 4 + nq * ne
                bms, by = chip_smoke.bound(nbytes, nq * ne * d * 3)
                print(json.dumps(dict(
                    phase="distance", shape=shape, nq=nq, ne=ne, d=d, metric=metric,
                    prune=prune, bound_ms=bms, bound_by=by, max_abs_err=err,
                    library_device_ms=None if prune else chip_smoke.device_ms(lib[metric]),
                    **row)), flush=True)
                free()
        del q, e
        free()


def scan_wall(fns: dict, order: list[str], dev, reps: int = 3):
    """Phase 3 (module docstring)."""
    import torch

    import chip_smoke
    from repro_torch.core.distributed import brute_force_knn
    from repro_torch.kernels import distance
    nq, ne, d = SHAPES["path"]
    q, e = inputs(nq, ne, d, dev)
    _, _, wall = chip_smoke.timers(dev.type == "cuda")
    saved = distance._launch
    row = {}
    try:
        for name in order:
            f = fns[name]
            distance._launch = lambda lib, *a, f=f: f(*a)
            got = [wall(lambda: brute_force_knn(e, q, k=11, device=dev))[1] * 1e3
                   for _ in range(reps)]
            row.setdefault(f"ms_{name}", []).extend(got)
    finally:
        distance._launch = saved
    dist = fns["new"](q, e, "d_inf", None, None)[0]
    row["kernel_device_ms"] = chip_smoke.device_ms(lambda: fns["new"](q, e, "d_inf", None, None))
    row["sort_device_ms"] = chip_smoke.device_ms(
        lambda: torch.sort(dist, dim=1, stable=True), iters=5)
    print(json.dumps(dict(phase="brute_force_knn", nq=nq, ne=ne, d=d, k=11,
                          metric="d_inf", **row)), flush=True)


def sustained(fn, on_card: bool, seconds: float = SUSTAIN_S) -> dict:
    """Phase 4 for one kernel call ``fn``: device ms of the calls run back
    to back for ``seconds``, and the median SM clock (MHz) and power draw
    (W) that ``nvidia-smi`` sampled meanwhile."""
    import statistics
    import time

    import torch
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    fn()
    sync()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True) if on_card else None
    try:
        n, t0 = 0, time.perf_counter()
        start = torch.cuda.Event(enable_timing=True) if on_card else None
        end = torch.cuda.Event(enable_timing=True) if on_card else None
        if on_card:
            start.record()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            n += 10
            sync()
        if on_card:
            end.record()
            sync()
    finally:
        if smi is not None:
            smi.terminate()
            out, _ = smi.communicate(timeout=30)
    row = dict(calls=n, device_ms=start.elapsed_time(end) / n if on_card else None)
    if smi is not None:
        samples = [ln.split(",") for ln in out.splitlines() if ln.count(",") == 1]
        clocks = [float(c) for c, _ in samples]
        row.update(samples=len(samples), sm_clock_mhz=statistics.median(clocks),
                   power_w=statistics.median(float(w) for _, w in samples))
    return row


def sustain_rows(fn, dev):
    """Phase 4 (module docstring) for the current build ``fn``."""
    nq, ne, d = SHAPES["path"]
    q, e = inputs(nq, ne, d, dev)
    for metric in METRICS:
        row = sustained(lambda: fn(q, e, metric, None, None), dev.type == "cuda")
        print(json.dumps(dict(phase="sustained", nq=nq, ne=ne, d=d, metric=metric, **row)),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", action="append", required=True, metavar="NAME=PATH",
                    help="another revision of csrc/distance.cu (repeatable)")
    ap.add_argument("--probe", action="append", default=[], metavar="NAME=PATH",
                    help="a revision timed but not checked (repeatable)")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("distance_turns: no CUDA device available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "tools"), str(ROOT / "src")]
    import chip_smoke
    from frontier_turns import build_libs
    from repro_torch.kernels import _build, distance
    baselines = dict(b.split("=", 1) for b in opts.baseline)
    probes = dict(b.split("=", 1) for b in opts.probe)
    if "new" in baselines or "new" in probes or set(baselines) & set(probes):
        ap.error("'new' names the current kernel, and every name is used once")
    print(chip_smoke.nvidia_smi_line(), flush=True)
    libs = build_libs("distance", {n: Path(p).resolve()
                                   for n, p in {**baselines, **probes}.items()})
    new = distance._lib()
    builds = {n: (distance._declare(lib), log) for n, (lib, log) in libs.items()}
    builds["new"] = (new, _build.build_log("distance"))
    for name, (lib, log) in builds.items():
        print(json.dumps(dict(phase="build", build=name,
                              ptxas=chip_smoke.ptxas_summary(log),
                              sass_loops=sass_loops(Path(lib._name)))), flush=True)
    launch = distance._launch           # scan_wall swaps the module's own
    fns = {n: (lambda q, e, metric, rq, re_, lib=lib: launch(lib, q, e, metric, rq, re_))
           for n, (lib, _) in builds.items()}
    base = [n for n in fns if n != "new"]
    order = base + ["new", "new"] + base[::-1]
    dev = torch.device("cuda")
    scan_rows(fns, order, dev, frozenset(probes))
    checked = {n: f for n, f in fns.items() if n not in probes}
    scan_wall(checked, [n for n in order if n in checked], dev)
    sustain_rows(fns["new"], dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
