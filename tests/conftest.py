"""Test configuration: an 8-virtual-device CPU platform.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``); multi-device sharding is
tested on virtual devices via ``--xla_force_host_platform_device_count=8``
(SURVEY.md §4.5).  Nothing here needs a GPU.

This file must run before any test imports jax — pytest imports conftest
first, and XLA_FLAGS must be in the environment before backends initialize.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _flags += " --xla_force_host_platform_device_count=8"
# The suite is compile-bound.  Opt level 0 cuts XLA CPU compile ~30% with no
# measurable effect on the 1e-3..1e-5 equivalence tolerances (golden suite
# verified).
if "xla_backend_optimization_level" not in _flags:
    _flags += " --xla_backend_optimization_level=0"
os.environ["XLA_FLAGS"] = _flags.strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from fluid_tpu.utils.platform import setup_compile_cache  # noqa: E402

setup_compile_cache()


# ---- slow-marker plumbing ---------------------------------------------------
# Tests whose coverage overlaps a cheaper test are marked @pytest.mark.slow
# and skipped by default; run the full matrix with `pytest tests/ --runslow`.
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavyweight CPU compile; needs --runslow"
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow CPU compile (use --runslow)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
