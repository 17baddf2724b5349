"""Persistent XLA compilation cache — shared policy.

One implementation serves the CLI (``cilqr_tpu.__main__``), the benchmark,
``chip_smoke.py`` and the test suite (``tests/conftest.py``), so the cache
location cannot drift apart.  The location is ``JAX_COMPILATION_CACHE_DIR``
when that is set, else the fixed directory ``.jax_cache`` at the root of the
checkout (the path is part of what makes a cache hit, so it must not move).
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache")


def enable_compilation_cache() -> None:
    path = cache_dir()
    try:
        import jax

        # Fail fast on an unwritable cache dir: jax.config.update accepts
        # any string, so a bad path would otherwise surface only as
        # per-compile warnings and silently cold compiles.
        os.makedirs(path, exist_ok=True)
        probe = os.path.join(path, ".writable_probe")
        with open(probe, "w"):
            pass
        os.remove(probe)
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    except Exception as e:  # cache is an optimization; never block a run
        import warnings

        warnings.warn(
            f"cilqr_tpu: persistent compilation cache disabled "
            f"({path!r}: {e}); compiles will run cold",
            RuntimeWarning,
            stacklevel=2,
        )
