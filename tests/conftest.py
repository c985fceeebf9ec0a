import os

import pytest

# 8 virtual CPU devices so multi-device sharding paths are testable on the CPU
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent XLA compilation cache: the kill-and-resume / two-process / CLI
# tests spawn subprocesses that would recompile kernels the parent already
# built, and repeat suite runs recompile everything. JAX reads
# JAX_COMPILATION_CACHE_DIR itself, so spawned subprocesses inherit the cache
# through the environment. LCF_NO_TEST_CACHE=1 opts out (e.g. to time cold
# compiles).
if not os.environ.get("LCF_NO_TEST_CACHE"):
    _cache_dir = os.path.join(os.path.dirname(__file__), ".xla_cache")
    os.makedirs(_cache_dir, exist_ok=True)
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", _cache_dir)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="also run tests marked slow (long statistical runs)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long statistical/integration runs, skipped unless --runslow")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow test: run with --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
