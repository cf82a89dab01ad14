"""Test configuration.

Tests run hostless on CPU: Pallas kernels execute in interpret mode (the
TPU analogue of the race/indexing sanitizer the reference lacks — SURVEY.md
§5), and sharding tests run on a virtual 8-device CPU mesh via
``xla_force_host_platform_device_count`` (SURVEY.md §4.6).

Set FAT_TEST_BACKEND=tpu to run the same suite compiled on real hardware.
"""

import os

_backend = os.environ.get("FAT_TEST_BACKEND", "cpu")
if _backend == "cpu":
    # NOTE: the env may preinstall a TPU plugin that ignores JAX_PLATFORMS;
    # jax.config.update is authoritative.
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if _backend == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
# On TPU, f32 matmuls default to fast bf16 MXU passes; the parity suites
# compare f32-grade oracles and model paths, so pin full f32. (The kernels
# pin their own dots via _precision(); this covers test-side jnp/model math.)
# TPU-only: CPU computes f32 natively-exact, so the pin buys nothing there.
if _backend == "tpu":
    jax.config.update("jax_default_matmul_precision", "highest")


# --- XLA:CPU compile-accumulation guard -------------------------------------
# With ~400 tests in one process, XLA:CPU segfaults inside backend_compile
# after roughly 300 distinct compiled programs (reproduced twice at test
# ~305; any prefix under ~300 compiles is stable, and the same tests pass in
# isolation). Dropping the executable caches periodically keeps the resident
# program count bounded. Costs a few recompiles per window; hermetic
# correctness is unaffected.
import pytest  # noqa: E402

_TESTS_RUN = {"n": 0}


@pytest.fixture(autouse=True)
def _periodic_jax_cache_clear():
    yield
    _TESTS_RUN["n"] += 1
    if _TESTS_RUN["n"] % 100 == 0:
        jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; the test skips without one")
