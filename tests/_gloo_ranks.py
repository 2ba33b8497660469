"""Rank subprocesses for the port's multi-rank tests: ``WORLD`` Python
processes running one script, meeting through a ``file://`` init in a
directory, each writing ``out.<rank>.npz`` there (gloo on the CPU; NCCL
needs a card a rank and is not exercised by these tests)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4


def start_ranks(code: str, d: Path, world: int = WORLD) -> list:
    """``code`` (run as ``python -c code <rank> <init> <dir>``) started on
    ``world`` rank subprocesses; -> the processes, for ``finish_ranks``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    (d / "rendezvous").unlink(missing_ok=True)     # a failed start's
    init = f"file://{d / 'rendezvous'}"
    return [subprocess.Popen([sys.executable, "-c", code, str(r), init, str(d)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def finish_ranks(procs: list, d: Path, timeout: int = 240) -> list:
    """Wait for ``start_ranks``' processes; -> each rank's ``out.<rank>.npz``
    as a dict.  Every process is killed if any outlives ``timeout``
    seconds."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_DONE {r}" in so, se[-3000:]
    return [dict(np.load(d / f"out.{r}.npz")) for r in range(len(procs))]


def run_ranks(code: str, d: Path, timeout: int = 240, world: int = WORLD) -> list:
    """``code`` (run as ``python -c code <rank> <init> <dir>``) on ``world``
    rank subprocesses; -> each rank's ``out.<rank>.npz`` as a dict.  Every
    process is killed if any outlives ``timeout`` seconds."""
    return finish_ranks(start_ranks(code, d, world), d, timeout)
