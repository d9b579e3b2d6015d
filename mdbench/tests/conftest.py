"""The benchmark's own tests: CPU rehearsals at a small size, and tests
marked `card` that run on a CUDA card and skip without one.  Nothing here
imports JAX or the JAX package.

    python -m pytest mdbench/tests -q             # here, on the CPU
    python -m pytest mdbench/tests -q -m card     # on the card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    """Two CPU threads a test process: the rehearsals run side by side
    under pytest-xdist, and eight spinning threads each starve them."""
    import torch

    torch.set_num_threads(2)


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided inside the test, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest mdbench/tests -m card)")
    return torch.device("cuda", 0)


@pytest.fixture
def root():
    return ROOT
