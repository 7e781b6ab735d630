"""Tests of the benchmark harness.  Run from the repository root:

    python -m pytest annbench/tests -q           # on the CPU; card tests skip
    python -m pytest annbench/tests -q -m chip   # on a machine with a card
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided per test)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
