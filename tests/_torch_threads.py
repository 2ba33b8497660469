"""One torch CPU thread for a test module's many small ops.

Under the parallel test run every pytest-xdist worker's intra-op thread
pool contends for the same cores, and a smoke model's training step (a
few thousand small ops, each a parallel region) then takes minutes
instead of a second.  A module that imports ``one_torch_thread`` runs
with one thread and gives the worker its thread count back at its end.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
