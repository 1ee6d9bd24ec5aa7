"""Tests of the benchmark harness. They import neither jax nor tpu_ann;
tests that need the card carry the ``cuda`` marker and skip, decided
inside a fixture, where there is none. On the card:
``python -m pytest portbench/tests -q -m cuda``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (runs the harness on the card)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
