"""A fixture for port test files whose work is many small tensor ops.

The suite runs in several worker processes on one host, and each process's
PyTorch would use a thread per core for its intra-op parallel regions. With
the cores already busy those threads are descheduled and every region waits
at its barrier: a file that takes seconds alone takes minutes. One thread
keeps such a file near its standalone time. Import the fixture into a test
module to apply it there."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
