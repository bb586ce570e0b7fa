"""Test configuration: run on a virtual 8-device CPU mesh in float64.

The GPU production path runs float32 (+ float64 polish); tests validate
numerical parity with the reference semantics in float64 on the XLA CPU
backend, the fused GPU kernel through the Pallas interpreter, and
multi-chip sharding on 8 virtual host devices
(xla_force_host_platform_device_count). Tests that need a card carry the
``gpu`` marker and skip here (the ``gpu_device`` fixture); on a card,
``python chip_smoke.py`` runs the same checks at full size.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # parity tests run on the XLA CPU backend
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# jax may already be imported (and have read JAX_PLATFORMS) before this
# file runs -- set the platform through the config API as well.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when the test runs, never at
    collection (every xdist worker must collect the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; this run computes on {dev.platform}")
    return dev
