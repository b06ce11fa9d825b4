"""Test config.

By default every test runs on the CPU backend with 8 virtual devices, so
the sharding logic is exercised without several accelerators.  A process
that has already brought up JAX (chip_smoke.py runs the `gpu`-marked tests
in its own process, on the card) keeps its platform: nothing here touches
an initialized backend.  `JAX_PLATFORMS`, when set, is respected.

Tests marked `gpu` take the `gpu_device` fixture, which decides at run
time whether there is a card: without one they skip, or fail under
`--require-gpu`.
"""
import os

import jax
import pytest
from jax._src import xla_bridge

if not xla_bridge.backends_are_initialized():
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    jax.config.update(
        "jax_platforms", os.environ.setdefault("JAX_PLATFORMS", "cpu"))


def pytest_addoption(parser):
    parser.addoption(
        "--require-gpu", action="store_true",
        help="fail, instead of skipping, gpu-marked tests without a GPU",
    )


@pytest.fixture
def gpu_device(request):
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if gpus:
        return gpus[0]
    if request.config.getoption("--require-gpu"):
        pytest.fail(f"no GPU visible to JAX (devices: {jax.devices()})")
    pytest.skip("needs an NVIDIA GPU; run `python chip_smoke.py` on the card")
