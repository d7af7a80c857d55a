"""The benchmark's own pytest settings: `python3 -m pytest port_bench/tests`.

Tests that need the card carry the `gpu` marker and take the `card`
fixture, which skips them where torch sees no CUDA device; whether there
is a card is decided there, never while a module is imported.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark measures the card only")
    return torch.cuda.get_device_name(0)
