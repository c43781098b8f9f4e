"""Test configuration: an 8-device virtual CPU mesh by default.

Unless JAX_PLATFORMS names a platform, jax is pointed at the CPU *before
any array op runs* (conftest imports before test modules), with 8 virtual
CPU devices so every sharding/collective path (data/model/seq parallel)
runs without a cluster — SURVEY.md §4 "Distributed without a cluster".

Tests marked `gpu` need an NVIDIA card.  They skip elsewhere; on the card
run them in one process (README):

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:xdist
"""

import os

import jax

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _gpu_marked_tests_need_a_gpu(request):
    """Skip `gpu`-marked tests where JAX finds no GPU — decided here, per
    test, never while modules are collected."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `JAX_PLATFORMS=cuda python "
                    "-m pytest tests/ -m gpu -p no:xdist` on the card")
