"""The benchmark's tests. Run them with `python -m pytest vosbench/tests`
from the repository's root. Tests marked `card` need a CUDA device: they
decide so inside the `card` fixture and skip elsewhere."""

from __future__ import annotations

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _one_thread():
    """ATen on one thread: the CPU tests share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
