"""The benchmark's own tests: ``python -m pytest -q -p no:cacheprovider
portbench/tests`` from the root of a checkout (CPU; the card's tests
skip without one)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is there."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
