"""Tests of the benchmark itself, run apart from the repository's suite:

    python -m pytest lz4bench/tests -q

Tests marked ``chip`` need a CUDA card and skip without one; on the card
machine they run with ``python -m pytest lz4bench/tests -q -m chip``.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
