"""Test harness setup: run everything on CPU with 8 fake devices so the
distributed paths are exercised without GPUs (SURVEY.md §4.3).

Must set the env vars before jax is imported anywhere. The tests marked
``gpu`` run on a card with ``OCEAN_TESTS_ON_GPU=1 python -m pytest -m gpu
tests/`` (README); that variable leaves JAX's platform choice alone, and the
``gpu_device`` fixture skips them wherever JAX finds no GPU.
"""

import os

import pytest

ON_GPU = os.environ.get("OCEAN_TESTS_ON_GPU") == "1"
if not ON_GPU:
    # Force CPU even on a machine with a GPU: unit/parity/distributed tests
    # are CPU-by-design; chip_smoke.py and bench.py run on the card.
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU:
    # the config update pins the platform even if a plugin registered
    # before the environment variable was read
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu_device():
    """The first GPU JAX sees; skips the test where there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: run with OCEAN_TESTS_ON_GPU=1 on a card")
