"""Shared fixtures of the benchmark's tests.  Run them from the root of the
checkout: python -m pytest portbench/tests -q (the card's cases are marked
``cuda`` and skip without one)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is there."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
