"""The benchmark's tests. Those marked `card` need a CUDA device and skip
without one (the check is made inside the `card` fixture, never at import);
run them on a machine with the card:

    python -m pytest -m card posebench/tests
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
