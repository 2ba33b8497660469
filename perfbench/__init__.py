"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Each
configuration, traffic mix and per-layer metric lives in a file of its own
(``configs/``, ``traffic/``, ``metrics/``), found by the name that
``BENCHMARK.json`` gives it.  Nothing here imports ``jax`` or the JAX
package ``repro``; the plain references in ``reference/`` import nothing of
the port either.
"""
