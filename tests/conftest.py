"""Test environment: JAX on an 8-device virtual CPU platform, configured
before JAX initializes a backend, so sharding tests run without
accelerators. Tests that need a GPU carry the `gpu` marker and decide in the
`gpu_device` fixture whether there is one (README: how to run them on a
card)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# Several test workers compile at once; JAX's persistent compilation cache
# (which main.py turns on) is not safe for concurrent writers of one entry.
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU device visible to JAX")
