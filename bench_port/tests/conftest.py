"""The benchmark's own tests (`python -m pytest bench_port/tests`): on the
CPU, and tests marked `cuda` on the card."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture()
def card():
    """Skip the test where no CUDA device is present (decided here, never
    at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
