"""The benchmark's own tests.  Tests that need a CUDA card carry the `card`
marker and skip, with a reason, where there is none; whether there is one is
decided inside the `card` fixture, never while a module is imported."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (runs on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
