"""Persistent-compilation-cache product tests.

The reference app has zero compile latency (wgpu pipelines build in
milliseconds, lib.rs:17-42); our jitted pipeline takes tens of seconds to
compile.  Session construction enables the persistent cache
(utils/cache.py): these tests prove a SECOND process reuses the first one's
executables, and that the cache lands where ``JAX_COMPILATION_CACHE_DIR``
says, or at the fixed directory in the checkout when it is unset.
"""

import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cmd, env):
    t0 = time.time()
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return time.time() - t0


def test_second_process_reuses_compilation_cache(tmp_path):
    cache_dir = tmp_path / "cache"
    env = os.environ.copy()
    env.update(
        JAX_PLATFORMS="cpu",
        JAX_COMPILATION_CACHE_DIR=str(cache_dir),
        # cache every executable: the small demo compiles in about a second
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
        TREEE_APP_CONFIG="small",
    )
    env.pop("TREEE_NO_COMPILE_CACHE", None)
    cmd = [
        sys.executable, "-m", "treee_tpu.app", "--demo", "--no-segment",
        "--frames", "1", "--width", "96", "--height", "64",
        "--out-dir", str(tmp_path / "frames"),
    ]
    cold = _run(cmd, env)
    entries = {p.name for p in cache_dir.rglob("*") if p.is_file()}
    assert entries, "first run populated no cache entries"

    warm = _run(cmd, env)
    entries2 = {p.name for p in cache_dir.rglob("*") if p.is_file()}
    assert entries2 == entries, (
        f"warm run compiled new executables: {entries2 - entries}")
    # interpreter+import overhead is common to both runs; the compile time
    # saved must still show through.  The zero-new-entries assertion above
    # is the real pin — wall time on a loaded 1-CPU host is noisy (this
    # flaked under a concurrent bench run), so allow one retry and a
    # generous bound before calling it a failure.
    if not warm < cold:
        warm = min(warm, _run(cmd, env))
    assert warm < cold * 1.5, (
        f"warm {warm:.1f}s exceeds the 1.5x-of-cold bound "
        f"(cold {cold:.1f}s) even after a retry — cache loading appears "
        "more expensive than compiling")


def test_cache_opt_out(tmp_path):
    """TREEE_NO_COMPILE_CACHE=1 leaves the cache directory untouched."""
    cache_dir = tmp_path / "cache"
    env = os.environ.copy()
    env.update(
        JAX_PLATFORMS="cpu",
        JAX_COMPILATION_CACHE_DIR=str(cache_dir),
        TREEE_APP_CONFIG="small",
        TREEE_NO_COMPILE_CACHE="1",
    )
    cmd = [
        sys.executable, "-c",
        "from treee_tpu.pipeline import Session; import numpy as np;"
        "s = Session.from_points(np.zeros((64, 3), np.float32));"
        "print('ok')",
    ]
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert not cache_dir.exists() or not any(cache_dir.rglob("*"))


@pytest.mark.parametrize("from_env", [True, False])
def test_cache_directory_selection(tmp_path, from_env):
    """With JAX_COMPILATION_CACHE_DIR set the cache uses exactly that
    directory; without it, the fixed ``.jax_cache`` in the checkout."""
    env = os.environ.copy()
    env.update(JAX_PLATFORMS="cpu")
    env.pop("TREEE_NO_COMPILE_CACHE", None)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if from_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "c")
    code = ("import jax; from treee_tpu.utils import cache;"
            "assert cache.enable_compilation_cache();"
            "print(cache.cache_dir()); print(jax.config.jax_compilation_cache_dir)")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    chosen, jax_dir = r.stdout.split()
    want = (str(tmp_path / "c") if from_env
            else os.path.join(REPO, ".jax_cache"))
    assert chosen == want and jax_dir == want
