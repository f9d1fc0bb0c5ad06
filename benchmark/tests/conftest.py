"""pytest settings of the benchmark's own tests: the ``card`` marker, and
the fixture that skips a card test where there is no card (decided when
the test runs, never when a module is imported)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (CUDA); skipped on the CPU")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda", 0)
