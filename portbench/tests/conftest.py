"""The benchmark's own tests (CPU; run from the root of the checkout):

    python3 -m pytest portbench/tests -q

Tests marked ``card`` need an NVIDIA card and skip without one; on the
chip: ``python3 -m pytest portbench/tests -q -m card``.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided here, never
    at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this machine")
    return torch.cuda.get_device_name(0)
