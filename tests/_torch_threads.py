"""A fixture for the port's CPU tests that compare two runs bit for bit.

Two runs of the same CPU computation agree bit for bit only when their
matrix products split their sums the same way, and the BLAS may pick
another number of threads for the same product when the machine is
loaded (its dynamic threading): a bitwise comparison of two runs then
fails by an ulp now and then.  One thread fixes the split.  Imports no
JAX."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
