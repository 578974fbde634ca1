import os

# XLA_FLAGS is read at backend initialization, so setting it here (before any
# jax computation) takes effect even if jax is already imported.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from onnx_quantize_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# Tests run on a virtual 8-device CPU mesh so sharding/collective paths are
# exercised without an accelerator (SURVEY.md §4 implication (c)). Set through
# jax.config, which is honored until the first backend is initialized, in
# case jax was imported before this file ran. chip_smoke.py runs the
# ``gpu``-marked tests in its own process on the card (OQT_TESTS_ON_GPU=1).
if os.environ.get("OQT_TESTS_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
# XLA CPU first-time compiles can be slow; persist them across runs (the
# repo's one cache rule, see utils/compile_cache.py).
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The GPU for ``gpu``-marked tests; skips where JAX has none. Decided
    here, at run time, never while a module is imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: chip_smoke.py runs the gpu-marked tests")
    return dev


# Compile-heavy tiers (multi-device shard_map programs, sliding-window ppl
# sweeps): auto-marked `slow` so `pytest -m "not slow"` is a fast pre-commit
# unit gate, mirroring the reference's unit/integration split
# (/root/reference/.github/workflows/main.yml:55-74). The full suite (no
# marker filter) remains the merge gate.
_SLOW_PATHS = (
    "tests/integration/",
    "tests/parallel/test_cp.py",
    "tests/parallel/test_pp.py",
    "tests/engine/test_kv_ppl.py",
)


def pytest_collection_modifyitems(config, items):
    for item in items:
        path = str(item.fspath).replace(os.sep, "/")
        if any(p in path for p in _SLOW_PATHS):
            item.add_marker(pytest.mark.slow)
