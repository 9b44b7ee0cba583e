"""Test configuration.

Tests run on a virtual 8-device CPU mesh so multi-device sharding logic is
exercised without a GPU (chip_smoke.py runs the same paths on real cards).
These env vars must be set before jax initialises its backends.
"""

import os

# Force CPU: unit tests never take the accelerator, even where one is present
# (tests that need a card carry the `gpu` marker and skip without one).
os.environ["JAX_PLATFORMS"] = "cpu"
# x64 so the M=1 (mean-error) strategy matches the reference's C doubles.
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402

# pytest plugins may import jax before this conftest runs, in which case the
# env vars above were read too late — force the config directly.
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import json  # noqa: E402
import pytest  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(scope="session")
def golden_manifest():
    with open(os.path.join(GOLDEN_DIR, "manifest.json")) as f:
        return json.load(f)


def golden_path(name: str) -> str:
    return os.path.join(GOLDEN_DIR, name)


@pytest.fixture(scope="session")
def golden_dir():
    return GOLDEN_DIR
