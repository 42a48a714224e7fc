"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches must
see the real single CPU device; only launch/dryrun.py fakes 512 devices.

If the real ``hypothesis`` package is unavailable, a minimal deterministic
fallback (tests/_vendor/hypothesis) is put on sys.path so the property-based
modules still collect and run everywhere (requirements-dev.txt installs the
real thing).
"""
import os
import sys

try:
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "_vendor"))

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skipped where there is none)")
