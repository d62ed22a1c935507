"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

Multi-device sharding is validated on a virtual CPU mesh; numerical parity
tests need f64.  ``JAX_PLATFORMS`` is left alone when the caller sets it,
so the ``gpu``-marked tests can run on a card (see the README).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

# whole-solve while-loops take seconds each to compile and dominate suite
# wall time; repeat runs hit the persistent cache instead
from diffsol_tpu.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test, never
    at import, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: runs on the card, see the README")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop in-memory jit caches after each test module.

    The XLA CPU compiler segfaults deterministically (inside
    backend_compile) once a single process has accumulated the whole
    suite's worth of live compiled whole-solve executables — every test
    file passes in isolation.  Clearing between modules bounds the live
    set; the persistent on-disk cache keeps the recompiles cheap.
    """
    yield
    jax.clear_caches()
