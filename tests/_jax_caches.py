"""The port's parity test modules start and end with JAX's caches cleared.

Every XLA:CPU executable that JAX keeps in its compilation caches holds
six memory mappings of the process, and a Linux process may hold at most
``vm.max_map_count`` mappings (65,530 by default).  One pytest-xdist worker
runs many test modules of both packages one after another and JAX keeps
every executable they compiled, jitted functions and eager primitives
alike: past about 10,900 live executables the next mapping fails and XLA
crashes inside a compile (SIGSEGV).  The worker dies, and the test that
was compiling is reported as failed (``tests/test_torch_jax_caches.py``
pins both the mechanism and this fixture's use).

Each ``tests/test_torch_*.py`` that imports the JAX package imports
``cleared_jax_caches`` from here; being autouse and module-scoped, it
clears the caches before the module's first test and after its last, so a
port module neither inherits the executables of the modules a worker ran
before it nor leaves its own to the next.
"""
import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def cleared_jax_caches():
    jax.clear_caches()
    yield
    jax.clear_caches()
