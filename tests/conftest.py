"""Test config: force JAX onto a virtual 8-device CPU mesh so sharding
paths are exercised without TPU hardware.

Note: jax may already be imported by the environment (site preload), so
env vars alone are not enough — use jax.config.update, which takes
effect as long as the backend hasn't initialized yet. XLA_FLAGS is read
at backend init, so setting it here still works.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled XLA programs after each test module: a full-suite
    run accumulates ~250+ CPU executables alongside torch in one
    process and the XLA CPU client has been seen to segfault near the
    end of the suite (flaky, never reproducible on a half-suite or a
    single file). Cross-module jit reuse is negligible — every module
    builds its own tiny models — so this costs little."""
    yield
    jax.clear_caches()
