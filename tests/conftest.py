"""Test configuration: force CPU with 8 virtual devices for sharding tests.

Mirrors the reference's test env (JAX_PLATFORMS=cpu, debug NaNs —
differt/pyproject.toml:207-210) plus a fake 8-device mesh so multi-device
sharding code paths run in CI without accelerators (SURVEY.md section 4).
Code that only runs compiled on the GPU is checked by ``chip_smoke.py``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_debug_nans", True)

assert jax.default_backend() == "cpu"
assert len(jax.devices()) == 8, "expected 8 virtual CPU devices for sharding tests"


@pytest.fixture
def key():
    return jax.random.key(1234)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
