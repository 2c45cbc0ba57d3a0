"""Test configuration.

All tests run on CPU with 8 virtual XLA devices (multi-device sharding tests
without hardware, SURVEY.md §4) and float64 enabled — the verification
precision mode that backs the 1e-6 oracle-agreement bar (SURVEY.md §7
"Numerics"). GPU measurements are separate (chip_smoke.py, bench.py); tests
that need a card are marked ``gpu`` and decide in a fixture.

The platform is pinned both by the environment and by jax.config, before
any backend initializes.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
assert jax.devices()[0].platform == "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)
