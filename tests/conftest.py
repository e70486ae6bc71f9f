"""Test harness: force an 8-device virtual CPU platform so sharding /
multi-chip paths are exercised without TPU hardware (SURVEY.md §4).

Must run before the first ``import jax`` anywhere in the test session.
"""

import os

# The session env may pin JAX_PLATFORMS to the TPU plugin; tests must run on
# the virtual CPU mesh, so override rather than setdefault.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(1234)
