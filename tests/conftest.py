import os
import sys

# tests must see exactly ONE device (dry-run sets its own 512-device flag in
# a separate process); make sure nothing leaks in.
os.environ.pop("XLA_FLAGS", None)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU with nvcc; skips without one")
