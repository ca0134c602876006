"""Test session config: an 8-device virtual CPU mesh unless told otherwise.

The suite runs on the CPU (fast, deterministic); multi-device sharding is
validated on the virtual device mesh. Tests marked ``gpu`` need an NVIDIA
GPU and skip elsewhere; run them on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``. x64 is enabled so
float64 parity oracles (traffic ARZ, Navier-Stokes) are exact — the package
itself uses explicit dtypes throughout.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX platform is "
                    f"{jax.default_backend()!r})")
