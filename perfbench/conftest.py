"""Fixtures of the benchmark's own tests (``python -m pytest perfbench``).

``TINY`` cuts each cell to a size the CPU runs in seconds, through the
plain versions of the port's kernels; the card-only tests take ``SMALL``.
Both reach the drivers through ``harness.run_cell``'s ``overrides``, never
through a command-line switch."""
from __future__ import annotations

import pytest
import torch

TINY = {
    "idx1m-dinf.knn-exact": {"config": {"n_objects": 3000, "max_frontier": 256},
                             "traffic": {"clients": 32, "cohort_width": 16,
                                         "check_queries": 64, "check_stride": 4,
                                         "warmup_cohorts": 1}},
    "idx1m-dinf.churn": {"config": {"n_objects": 3000, "max_frontier": 256},
                         "traffic": {"deletes": 16, "inserts": 16, "probe_queries": 64,
                                     "probe_width": 16}},
    "sc2-knnlm.decode-b256": {"config": {"n_layers": 2, "d_model": 64, "n_heads": 4,
                                        "n_kv_heads": 2, "d_ff": 128, "vocab_size": 256,
                                        "datastore_keys": 2000, "max_frontier": 256},
                             "traffic": {"batch": 8, "prompt_len": 4, "gen_steps": 12,
                                         "check_rows": 2}},
}

SMALL = {
    "idx1m-dinf.knn-exact": {"config": {"n_objects": 50000},
                             "traffic": {"check_queries": 512}},
    "idx1m-dinf.churn": {"config": {"n_objects": 50000}, "traffic": {"probe_queries": 256}},
    "sc2-knnlm.decode-b256": {"config": {"n_layers": 4, "d_model": 768, "n_heads": 6,
                                        "n_kv_heads": 2, "d_ff": 3072, "vocab_size": 8192,
                                        "datastore_keys": 4096, "max_frontier": 256},
                             "traffic": {"gen_steps": 32}},
}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA device for the card-only tests; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
