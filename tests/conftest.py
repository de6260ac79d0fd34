"""Test configuration: CPU platform with 8 virtual devices, float64.

``JAX_PLATFORMS`` picks another platform where it is set; the tests
marked ``gpu`` run only on a GPU.

Mirrors the reference's global float64 fixture
(``tests/linpde_gp/conftest.py:1-3``) and adds the virtual multi-device
mesh used by the ``parallel`` tests (the driver validates real multi-chip
sharding separately via ``__graft_entry__.dryrun_multichip``).
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` run only where JAX computes on a GPU; the
    check runs per test, so every worker collects the same tests."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU visible to JAX")
