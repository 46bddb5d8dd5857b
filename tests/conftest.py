"""Test harness: the CPU backend with 8 virtual devices.

Multi-device sharding tests run on an emulated 8-device CPU mesh.  Tests
marked ``gpu`` need a card: they take the ``gpu_device`` fixture, which skips
them unless the run was started with ``TREEE_TEST_PLATFORM=gpu`` on a machine
with a GPU (``TREEE_TEST_PLATFORM=gpu python -m pytest -m gpu tests/``).
"""

import os
import sys

import jax
import pytest

if os.environ.get("TREEE_TEST_PLATFORM") != "gpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when this run has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU: run with TREEE_TEST_PLATFORM=gpu on a card")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    Full-suite runs accumulate ~200 compiled XLA CPU executables; past that
    point one of the late segmentation compiles (tests/test_tiles.py) asks
    the allocator for a pathological ~66 TB block (kernel __vm_enough_memory
    denial in dmesg) and intermittently SEGFAULTS the whole run — state-
    dependent: the same test alone never attempts that allocation.  Clearing
    between modules keeps the live-executable set small; within-module
    compile reuse (where shapes actually repeat) is unaffected.
    """
    yield
    jax.clear_caches()
