"""Fixtures of the benchmark's tests."""

import pytest
import torch
from pb_helpers import make_root


@pytest.fixture
def card():
    """The card, for the tests marked ``card``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
