"""The readings that set each cell's limits, on the card at the cell's own
size: for every seed, one run of the cell whose numbers are the program's
(sound) readings, and the same numbers worked out by the control (the
plain reference in the next lower precision in the program's place).

    python3 perfbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

One process for all the seeds (a cell's set-up is paid once a seed, its
imports and kernel builds once); one JSON line a seed on standard output.
The benchmark's own runs (``run.py``) never compute the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness
    if not torch.cuda.is_available():
        print("perfbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        out = []
        line, checks = harness.run_cell(args.workload, seed, args.seconds, False,
                                        device="cuda", control=True, outcome=out)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": line["correct"], "metrics": line["metrics"],
                          "sound": {c.name: c.value for c in checks},
                          "limits": {c.name: c.limit for c in checks},
                          "control": out[0].sources.get("control")}), flush=True)
        del out, line
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
