"""Tests of the port's benchmark.  ``card``: the test needs a CUDA card; it
asks for the ``card`` fixture, which skips it where there is none, so that
every worker collects the same tests.  Run them all with
``python -m pytest portbench/tests -q`` (on a machine with a CUDA card the
card tests run too; the rest run everywhere)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda", 0)
