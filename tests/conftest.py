"""Test harness: force an 8-device virtual CPU mesh.

The standard JAX way to test pjit/shard_map sharding without a cluster
(SURVEY.md §4c). Must run before any backend initialization: the platform
is pinned to the CPU through jax.config (which wins as long as no device
has been touched yet), so the suite runs the same on a GPU machine.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
