"""Test harness config: force CPU jax with an 8-device virtual mesh.

Tests run on the CPU with 8 virtual devices unless JAX_PLATFORMS names
other platforms; the platform is set through jax.config before any backend
initialization. Tests that need a GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them where JAX has no GPU (the decision
is made inside the fixture, never at import, so every worker collects the
same tests). On the card: ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu_device():
    """The first GPU, or skip: these tests measure or compile for the card."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run on the card: see README)")
