"""Test setup of the benchmark's own tests (``test_portbench_*.py``).

Puts the repository's root and ``src/`` on the path, and registers the
``card`` marker: a test that needs a CUDA card takes the ``card``
fixture, which skips it, inside the test, where torch sees none. Whether
there is a card is never decided while a module is imported.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips where torch sees none)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda", 0)
