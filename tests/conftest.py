"""Test configuration.

By default the tests run on the CPU backend with 8 virtual devices, so the
multi-device sharding paths are exercised without a card.  Tests that need
the card carry the ``gpu`` marker and take the ``gpu`` fixture, which skips
them when jax's first device is not a GPU.  When exactly those tests are
asked for (``-m gpu``, as ``chip_smoke.py`` and the README run them on the
card), the platform is left to jax.
"""

import os

import pytest


def pytest_configure(config):
    if config.getoption("markexpr", "").strip() == "gpu":
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The GPU device; skips the test on any other backend."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (jax's first device is {dev.platform}); "
                    f"run on the card: python -m pytest -m gpu tests/")
    return dev
