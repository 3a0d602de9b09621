"""Test configuration: the CPU backend with 8 virtual devices, so the
sharding/halo-exchange logic is exercised without several cards
(SURVEY.md section 4).

Tests marked ``gpu`` need the card: run them there with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.  Every other run
is held to the CPU.  Whether a card is present is decided in fixtures,
never at import.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_sessionstart(session):
    if jax.default_backend() == "cpu":
        assert jax.device_count() == 8, jax.devices()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules.

    A full-suite single-process run accumulates every module's jitted
    XLA-CPU executables and segfaulted order-dependently deep into the
    sharded tests (~106/111 tests in, reproduced 2/2 in round 3's
    review).  Dropping the compilation caches at module boundaries keeps
    the live-executable population bounded to one module's worth; the
    cost is re-compiling shared helpers per module (CPU compiles,
    seconds)."""
    yield
    jax.clear_caches()
