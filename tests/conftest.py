"""Test configuration: run on CPU with 8 virtual devices.

Mirrors the reference's test strategy (SURVEY.md §4) but on a simulated
device mesh: kernels are validated against numpy oracles; sharding tests use
an 8-way virtual CPU mesh.  Must run before the first ``import jax``.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _flags = (_flags + " --xla_force_host_platform_device_count=8").strip()
# The XLA:CPU backend intermittently SIGSEGV/SIGABRTs when parallel LLVM
# codegen compiles this suite's very large programs (fused codec pipelines)
# after accumulated compilation state; single-split codegen avoids the
# crash.
if "xla_cpu_parallel_codegen_split_count" not in _flags:
    _flags += " --xla_cpu_parallel_codegen_split_count=1"
os.environ["XLA_FLAGS"] = _flags

# Update the live config too, in case jax was imported before this conftest
# ran, so tests really run on the virtual-CPU mesh.
import sys

import jax

jax.config.update("jax_platforms", "cpu")
# 64-bit element support (LONGLONG/ULONGLONG dtypes) requires x64 mode.
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

# Make tests/oracles importable as `oracles.*`.
sys.path.insert(0, os.path.dirname(__file__))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# `pytest -m quick`: the fast dev-loop tier.  Curated by module: these cover
# every public API surface in a couple of minutes; the excluded modules are
# the oracle-conformance sweeps, fuzz batteries and scaling tests that
# dominate the full suite's wall time.
_QUICK_MODULES = {
    "test_core",
    "test_ops",
    "test_batch_api",
    "test_cascaded",
    "test_lz4",
    "test_snappy",
    "test_highlevel",
    "test_cli",
    "test_bench",
    "test_native",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.nodeid.split("::", 1)[0].rsplit("/", 1)[-1].removesuffix(".py")
        if mod in _QUICK_MODULES and "slow" not in item.keywords:
            item.add_marker(pytest.mark.quick)
