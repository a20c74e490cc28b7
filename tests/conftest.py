"""Test configuration.

By default the tests run on the CPU with 8 virtual devices, so the sharding
tests need no accelerator (the reference's single-process test strategy,
SURVEY.md §4, maps to mesh-on-CPU simulation here). With
``GPF_TEST_DEVICE=gpu`` JAX keeps its default platform, for the tests
marked ``gpu``; run those in one process (no ``-n``):

    GPF_TEST_DEVICE=gpu python -m pytest tests/ -m gpu -p no:xdist
"""

import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ON_CARD = os.environ.get("GPF_TEST_DEVICE") == "gpu"

if not ON_CARD:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402
import pytest  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips when JAX finds none")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r}); run "
                    "with GPF_TEST_DEVICE=gpu on a card")
    return dev
