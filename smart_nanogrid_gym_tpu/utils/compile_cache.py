"""Placement of JAX's persistent compilation cache.

The entry points (``chip_smoke.py``, ``bench.py`` and the ``tools/`` CLIs)
call :func:`enable_compile_cache` before their first compile.  Where the
environment sets ``JAX_COMPILATION_CACHE_DIR``, JAX reads it itself and the
helper changes nothing; otherwise the cache goes to ``<repo root>/.jax_cache``.
The path is fixed (no temp dir, pid or time in it) because it is part of the
cache key: a directory that moves never hits.
"""

from __future__ import annotations

import os

import jax

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory: ``JAX_COMPILATION_CACHE_DIR`` when set, else
    :data:`DEFAULT_CACHE_DIR`."""
    from_env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if from_env:
        return from_env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
