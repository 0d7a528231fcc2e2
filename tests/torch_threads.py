"""The autouse fixture of the port's test files, which import it by name:
one torch intra-op thread for each test."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for these tiny shapes: the default (one a core)
    makes every small op a parallel region, whose threads crawl, and take
    cores from the tests beside them, when parallel test workers
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
