"""Test configuration.

The suite runs on the CPU (`JAX_PLATFORMS=cpu`).  Multi-device sharding paths
are exercised on a host-platform device mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8), per the multi-chip test
strategy in SURVEY.md §4.

Tests that need an NVIDIA GPU carry the `gpu` marker and take the `gpu`
fixture, which skips them when the process has no GPU; run them on a machine
with a card with `python -m pytest -m gpu tests/`.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)

import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--regen-goldens", action="store_true", default=False,
        help="rewrite tests/goldens/*.png from the current renderer output",
    )


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: takes >8s; excluded from smoke")
    config.addinivalue_line(
        "markers",
        "smoke: fast tier, every test not marked slow")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere")


def pytest_collection_modifyitems(config, items):
    for item in items:
        # Every test not explicitly marked slow belongs to the smoke tier.
        if item.get_closest_marker("slow") is None:
            item.add_marker(pytest.mark.smoke)
        if "gpu" in getattr(item, "fixturenames", ()):
            item.add_marker(pytest.mark.gpu)


@pytest.fixture
def gpu():
    """The process's GPU, decided when the test runs (never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with `pytest -m gpu` on a card)")
    return jax.devices()[0]
