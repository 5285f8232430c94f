"""CPU tests of the benchmark harness (the `cuda` ones skip without a
card). They import neither jax nor the JAX package."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")
