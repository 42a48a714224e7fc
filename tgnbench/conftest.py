"""Fixtures of the benchmark's own tests."""
import pytest


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs beside other workers."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
