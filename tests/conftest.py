"""Test configuration: hermetic CPU backend with a virtual 8-device mesh.

The reference has no tests (SURVEY.md §4); this suite creates the
verification story: unit tests vs the NumPy oracle, trajectory-level ATE
tests on the simulator, and sharding tests on a virtual CPU mesh (standard
JAX pattern — multi-chip logic validated without a pod).
"""
import os

# Must be set before jax import: 8 virtual CPU devices for sharding tests.
# Forced (not setdefault): tests never touch an accelerator, even on a
# machine that has one — unless EKF_SLAM_TEST_PLATFORMS names it, which is
# how the card-only tests (marker ``gpu``) run on the card:
#   EKF_SLAM_TEST_PLATFORMS=cuda python -m pytest tests/ -m gpu
PLATFORMS = os.environ.get("EKF_SLAM_TEST_PLATFORMS", "cpu")
os.environ["JAX_PLATFORMS"] = PLATFORMS
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Pin the platform through the config API as well, so a plug-in that sets
# jax_platforms cannot override the environment variable.
jax.config.update("jax_platforms", PLATFORMS)

# f64 so the jitted math can be compared against the f64 NumPy oracle
# tightly; production runs use f32 (params.dtype).
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound in-process compiler-state growth across the ~230-test run.

    Full-suite runs intermittently died with a segfault/abort INSIDE an
    XLA CPU compile late in the run (observed at 64-96% in three
    different tests, including once with nothing else on the host) —
    consistent with accumulated compiled-executable state, not with any
    single test.  Dropping the jit caches between modules keeps the live
    executable population bounded; modules rarely share programs, so the
    recompile cost is small."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """Skip the test unless JAX's devices are GPUs (decided here, at run
    time, never while modules are imported)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with "
                    "EKF_SLAM_TEST_PLATFORMS=cuda ... -m gpu on the card)")
    return jax.devices()
