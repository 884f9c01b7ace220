import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny CPU models: one torch thread, as the repo's tests of many tiny
    ops run (a full thread pool a worker makes them many times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
