"""Test harness config.

Defaults to the CPU backend with 8 virtual devices so pjit/mesh/sharding
paths are exercised without several cards (SURVEY.md §4). Must run before
jax is imported anywhere. Tests marked ``gpu`` need an NVIDIA GPU: they
skip elsewhere, and ``python chip_smoke.py`` runs them on the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(autouse=True)
def _needs_gpu(request):
    """Skip ``gpu``-marked tests unless JAX's default device is a GPU
    (decided here, at run time, never while modules are imported)."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs an NVIDIA GPU; run `python chip_smoke.py` on "
                    "the card")
