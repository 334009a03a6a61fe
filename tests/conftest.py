import os
import sys

# smoke tests and benches must see 1 device (the dry-run sets its own 512);
# never set xla_force_host_platform_device_count here.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's kernels); "
        "skips where there is none")

# ---------------------------------------------------------------------------
# Graceful degradation when `hypothesis` is absent (see requirements-dev.txt):
# install a stand-in module so the property-test modules still COLLECT; every
# @given test then reports SKIPPED instead of erroring the whole module.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ImportError:
    import types

    def _settings(*args, **kwargs):
        if args and callable(args[0]):  # bare @settings
            return args[0]
        return lambda f: f

    def _given(*args, **kwargs):
        def deco(f):
            def skipper():
                pytest.skip("hypothesis not installed "
                            "(pip install -r requirements-dev.txt)")
            skipper.__name__ = f.__name__
            skipper.__doc__ = f.__doc__
            return skipper
        return deco

    class _Strategies(types.ModuleType):
        def __getattr__(self, name):
            return lambda *a, **k: None

    _mod = types.ModuleType("hypothesis")
    _mod.__doc__ = "stand-in: property tests skip when hypothesis is missing"
    _mod.given = _given
    _mod.settings = _settings
    _mod.strategies = _Strategies("hypothesis.strategies")
    _mod.HealthCheck = types.SimpleNamespace(too_slow=None, data_too_large=None)
    sys.modules["hypothesis"] = _mod
    sys.modules["hypothesis.strategies"] = _mod.strategies


# ---------------------------------------------------------------------------
# XLA executable accumulation: one pytest process compiles thousands of
# distinct shapes across the suite (every platform build clusters nodes of
# data-dependent sizes), and the CPU backend segfaults in backend_compile
# once enough live executables pile up (observed deterministically around
# the ~190th test; any subset prefix passes). Dropping the jit caches at
# module boundaries releases the executables and keeps the whole suite in
# one process; the recompiles cost seconds per module.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_per_module():
    yield
    import jax
    jax.clear_caches()


@pytest.fixture(scope="session")
def blobs():
    """Well-separated gaussian blobs: (x, labels, centers)."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(6, 12)).astype(np.float32) * 8
    lab = rng.integers(0, 6, 1500)
    x = (centers[lab] + rng.normal(size=(1500, 12))).astype(np.float32)
    return x, lab, centers
