"""The benchmark's own tests: run them from the root of the repository,

    python -m pytest portbench/tests -q

on the host (tiny sizes, the port's plain route on the CPU); the tests
marked ``cuda`` run the same checks at the cells' own sizes on a card.
"""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH.parent))
sys.path.insert(0, str(BENCH))


@pytest.fixture
def card():
    """The first card; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA build of torch)")
    return "cuda:0"
