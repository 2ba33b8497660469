"""Why the port's parity modules clear JAX's caches (``tests/_jax_caches.py``).

A pytest-xdist worker that ran the reference's compile-heavy modules in a
row (``test_chaos.py`` .. ``test_distance_kernel.py``) crashed with SIGSEGV
inside XLA's compile in the next module: a JAX-only sequence of those
modules does the same in one process, and clearing the caches at every
module boundary ends it.  Each live XLA:CPU executable holds memory
mappings, and ``vm.max_map_count`` bounds them per process.
"""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent


def _imports_the_reference(tree) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        else:
            continue
        if any(n.split(".")[0] in ("jax", "repro") for n in names):
            return True
    return False


def test_every_parity_module_clears_the_jax_caches():
    """Every port test module that imports jax or the JAX package takes
    the autouse ``cleared_jax_caches`` fixture."""
    files = sorted(TESTS.glob("test_torch_*.py"))
    using = []
    for f in files:
        tree = ast.parse(f.read_text(), filename=str(f))
        if not _imports_the_reference(tree):
            continue
        names = {a.name for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
                 and node.module == "_jax_caches" for a in node.names}
        assert "cleared_jax_caches" in names, f"{f.name} does not clear the JAX caches"
        using.append(f.name)
    assert len(using) >= 20 and "test_torch_stream_parity.py" in using


def test_live_executables_hold_memory_maps_until_the_caches_clear():
    """In a fresh process: 150 distinct jitted functions, kept alive, add
    at least 5 memory mappings each (so about 10,900 of them reach the
    default limit of 65,530); ``jax.clear_caches()`` gives nearly all of
    them back."""
    if not Path("/proc/self/maps").exists():
        pytest.skip("counts memory mappings through /proc (Linux)")
    code = textwrap.dedent("""
        import jax, jax.numpy as jnp
        maps = lambda: sum(1 for _ in open("/proc/self/maps"))
        x = jnp.ones((8,))
        (x * 2).block_until_ready()
        base = maps()
        keep = []
        for i in range(150):
            f = jax.jit(lambda a, i=i: a * i + a.sum())
            f(x).block_until_ready()
            keep.append(f)
        grown = maps()
        jax.clear_caches()
        print(base, grown, maps())
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    base, grown, cleared = map(int, proc.stdout.split())
    assert grown - base >= 5 * 150, (base, grown)
    assert cleared - base <= 0.1 * (grown - base), (base, grown, cleared)
