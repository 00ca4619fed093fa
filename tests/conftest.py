"""Shared test fixtures.

The full tier-1 run compiles thousands of distinct XLA programs in one
process (every engine x backend x schedule cell re-jits its epochs).  On
XLA:CPU each compiled executable pins LLVM JIT code memory for the life
of the process; past a few hundred test functions the accumulated
executables can crash the *next* compilation outright (segfault inside
``backend_compile``), taking the whole session down even though every
module passes in isolation.  Dropping jax's compilation caches between
modules releases the executables and keeps the per-process footprint
bounded; the price is a per-module recompile of the handful of shared
programs, which is noise next to the suite's own compile load.
"""
from __future__ import annotations

import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; the test skips itself (inside "
        "the test, never at collection) when torch sees no CUDA device")
