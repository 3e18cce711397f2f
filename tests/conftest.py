"""Shared fixtures. NOTE: no XLA_FLAGS here — tests must see the real device
count (only launch/dryrun.py forces 512 host devices)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; the test skips itself without one")
