"""pytest settings of the benchmark's tests: the `card` marker, and the
fixtures that decide, when a test runs, whether this machine has a card."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skipped without one")


def _has_card() -> bool:
    import torch
    return torch.cuda.is_available()


@pytest.fixture
def card():
    if not _has_card():
        pytest.skip("no CUDA device on this machine")


@pytest.fixture
def no_card():
    if _has_card():
        pytest.skip("this machine has a CUDA device")
