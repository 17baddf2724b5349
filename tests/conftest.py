"""Test configuration: an 8-device virtual CPU mesh and float64.

Multi-device sharding is validated on a reshaped single-host mesh (SURVEY.md
§4 implication 4).  Tests marked ``gpu`` compare the GPU kernels with XLA on
the card: ``python -m pytest tests/ -m gpu`` keeps the real platform (see
``pytest_configure``); every other selection runs on the CPU, where those
tests skip from their fixture.  Must run before the first backend use.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Persistent compilation cache: the heavy closed-loop / sharded-mesh tests
# are compile-bound on CPU; caching XLA executables across test runs cuts
# the full tier's wall time on any warm machine.  Shared policy with the
# CLI (utils/compile_cache.py).
from cilqr_tpu.utils.compile_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from cilqr_tpu.utils.params import SolverParams  # noqa: E402


def pytest_configure(config):
    """The GPU tier (``-m gpu``) keeps the card; everything else runs on the
    CPU in float64.  pytest and its workers pass the same options, so every
    worker decides alike."""
    if config.getoption("markexpr", "") != "gpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="session")
def params() -> SolverParams:
    return SolverParams()


def make_global_plan(n=120, dtype=np.float64):
    """A gently curving CARLA-like lane at Town02-scale coordinates."""
    s = np.linspace(0.0, 119.0, n)
    x = 90.0 + s
    y = -306.0 + 2.5 * np.sin(0.03 * s) + 0.01 * s
    return np.stack([x, y], axis=1).astype(dtype)


@pytest.fixture(scope="session")
def global_plan():
    return make_global_plan()


@pytest.fixture(scope="session")
def ego_state():
    return np.array([100.0, -305.6, 4.0, 0.05])
