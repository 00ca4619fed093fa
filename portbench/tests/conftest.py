"""The benchmark's CPU tests run torch on one intra-op thread, as
``run.py`` runs a cell: in a loaded test run (several workers, each with a
pool the size of the machine) the tiny cells' many small ops otherwise wait
on oversubscribed pools, and a tiny window ran 60 times slower than alone."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
