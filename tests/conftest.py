"""Shared fixtures.

NOTE: no XLA_FLAGS device-count forcing here — in-process tests must see the
real single CPU device (the harness rule).  Multi-device behaviour is tested
through subprocess batteries (tests/multidev_battery.py) which set
``--xla_force_host_platform_device_count`` privately.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.fixture(scope="session")
def mesh1():
    """A 1x1 mesh: degenerate but exercises every code path."""
    from repro.core.compat import make_mesh

    return make_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="session")
def abi1(mesh1):
    import repro.core as C

    return C.pax_init(mesh1, impl="paxi")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skipped without one)")
