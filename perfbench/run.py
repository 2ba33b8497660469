"""Run one cell of the benchmark once on the CUDA card(s) of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic mix (``BENCHMARK.json``),
builds the system and its inputs from ``--seed``, warms up, measures for
``--seconds`` seconds, checks what the timed path produced against the
plain reference, and prints the result as the last line of standard
output (the numbers compared, each beside its limit, are the last lines
of standard error).  It exits with another code than 0, and prints no
result, where there is no CUDA card (or fewer than the cell asks for), or
where JAX or the JAX package was loaded.  Kernels are built into
``build/`` inside the checkout, so only the first run of a checkout
compiles them.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the script's own folder first on sys.path would let its modules
    # shadow others; the package and the port are found from the root
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("USE_FLAX", "0")

    from perfbench import harness
    spec = harness.load_spec(ROOT)
    cell, _, traffic = harness.find_cell(spec, args.workload)
    if "cpu_threads" in traffic:
        # the mix's CPU thread budget, set before torch and numpy load
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
            os.environ.setdefault(var, str(traffic["cpu_threads"]))

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    limit = _power_limit()
    line, checks = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                    device="cuda", spec=spec, device_kind=kind)
    line["device"]["power_limit"] = limit
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    print(f"perfbench: {args.workload} seed {args.seed} on {kind}, power limit {limit}",
          file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    # "checks" comes last in the line, as run_cell built it
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
