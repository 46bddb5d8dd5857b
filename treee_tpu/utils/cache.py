"""Persistent XLA compilation cache for the product paths.

The reference app has zero compile latency (wgpu pipelines are built in
milliseconds, lib.rs:17-42); the jitted pipeline takes tens of seconds to
compile.  The persistent cache makes the SECOND process skip that.  Session
construction (and the CLI) calls :func:`enable_compilation_cache`.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads
it itself; this module then sets no directory), otherwise the fixed
directory ``.jax_cache`` at the root of the checkout.  A fixed path matters:
the directory is part of the cache key, so a moving one never hits.
``TREEE_NO_COMPILE_CACHE=1`` opts out.  Executables that compile in under
a second are not cached unless ``JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS``
says otherwise.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")
_enabled: bool | None = None


def cache_dir() -> str:
    """The directory the persistent cache uses (see the module docstring)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compilation_cache() -> bool:
    """Turn on JAX's persistent compilation cache at :func:`cache_dir`.

    Idempotent (first call wins); returns True when the cache is active.
    Safe to call before or after the backend initializes: JAX reads the
    config at compile time.
    """
    global _enabled
    if _enabled is not None:
        return _enabled
    if os.environ.get("TREEE_NO_COMPILE_CACHE", "") not in ("", "0"):
        _enabled = False
        return False
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    if not os.environ.get("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"):
        # the big pipeline executables are the point; 1 s skips trivia
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _enabled = True
    return True
