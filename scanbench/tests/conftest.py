"""scanbench's own tests: run with ``python -m pytest scanbench/tests``.
The CPU tests run anywhere; those marked ``chip`` need a CUDA card and
skip without one (``python -m pytest scanbench/tests -m chip`` on the
card)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The first CUDA device; the test skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)
