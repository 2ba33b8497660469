"""The port's four examples (``python -m repro_torch.examples.<name>``):
each runs to its end on the CPU in a process where JAX cannot be imported,
and the quickstart's kNN answers equal the JAX package's ``SMTreeEngine``
on the same data, computed here."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from _jax_caches import cleared_jax_caches  # noqa: F401  (autouse)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
SHORT = {"quickstart": [], "distributed_index": [],
         "knnlm_serve": ["--steps", "2", "--store-batches", "1"],
         "train_lm": ["--steps", "6"]}
LAST_LINE = {"quickstart": "ref: 100 deletes, SM invariant + min-fill verified",
             "distributed_index": "victims still self-matching: 0/8",
             "knnlm_serve": "post-eviction kNN-LM argmax:",
             "train_lm": "resumed run finished with loss"}


_RUN_ALL = """
import runpy, sys
sys.modules["jax"] = None
for name, argv in %r.items():
    print("=== " + name, flush=True)
    sys.argv = [name] + argv + ["--device", "cpu"]
    runpy.run_module("repro_torch.examples." + name, run_name="__main__")
print("=== end")
"""


def test_examples_run_on_the_cpu_without_jax():
    """The four examples as ``python -m`` runs them, one after another in
    one process that cannot import JAX (one process: each would pay the
    imports again), each to its last line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _RUN_ALL % (SHORT,)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out, name = {}, None
    for ln in proc.stdout.splitlines():
        if ln.startswith("=== "):
            name = ln[4:]
            out[name] = []
        elif not ln.startswith("[train]"):
            out[name].append(ln)
    assert list(out) == list(SHORT) + ["end"]
    for name in SHORT:
        assert out[name][-1].startswith(LAST_LINE[name]), (name, out[name])


def test_quickstart_answers_equal_the_reference_engine():
    from repro.core.engine import SMTreeEngine
    from repro.data.datagen import clustered
    from repro_torch.examples import quickstart
    got = quickstart.main(["--device", "cpu"])
    X = clustered(5000, dims=8, seed=0)
    res = SMTreeEngine.build(X, capacity=32).knn(X[:8] + np.float32(0.01), k=3,
                                                  max_frontier=256)
    np.testing.assert_array_equal(np.asarray(got["knn_dists"], np.float32),
                                  np.asarray(res.dists))
    np.testing.assert_array_equal(np.asarray(got["knn_ids"]), np.asarray(res.ids))
    np.testing.assert_array_equal(np.asarray(got["page_hits"]), np.asarray(res.page_hits))
