"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` exports plain C launch functions (no PyTorch
headers, so ``nvcc`` takes seconds, not minutes) and is compiled on its own
into ``build/repro_torch/<name>-<hash>.so`` under the repository root, with
the common flags plus its own (``EXTRA_FLAGS``: the kernels held bitwise to
their plain versions are built with ``--fmad=false``, so that no multiply
and add are contracted into one FMA; flash attention, held to a tolerance,
is not).  The hash covers the source and the flags, so an edited kernel is
rebuilt and an unchanged one is reused.  ``-Xptxas -v`` output (registers,
shared memory, spills) is kept beside each library in
``<name>-<hash>.log``.

Nothing is built at import: the first wrapper call on a CUDA tensor builds
what it needs, and ``build_all`` builds every source at once, one ``nvcc``
process each, all started together.  A failed build raises with nvcc's
output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
EXTRA_FLAGS = {"frontier": ("--fmad=false",), "distance": ("--fmad=false",)}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels are built from source at first use")
    return found


def flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, float]:
    """Build (or reuse) every source, one nvcc process each, started
    together.  Returns each source's wall-clock build seconds (0.0 when a
    cached library was reused)."""
    with _lock:
        return _build_locked(sources())


def _build_locked(names: list[str]) -> dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    secs: dict[str, float] = {}
    procs = {}
    for name in names:
        so = _target(name)
        if so.exists():
            secs[name] = 0.0
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so, time.perf_counter())
    failed = []
    for name, (proc, tmp, so, t0) in procs.items():
        out, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)     # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked([name])
            so = _target(name)
            lib = ctypes.CDLL(str(so))
            _libs[name] = lib
            _logs[name] = so.with_suffix(".log").read_text()
        return lib


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``) for the loaded library ``name``."""
    load(name)
    return _logs[name]
