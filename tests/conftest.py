import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); "
        "skips without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
