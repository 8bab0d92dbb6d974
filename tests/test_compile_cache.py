"""Placement of the persistent compilation cache (utils/compile_cache.py)."""

import os
import tempfile

import jax
import pytest

from smart_nanogrid_gym_tpu.utils.compile_cache import DEFAULT_CACHE_DIR, enable_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_setting(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    yield monkeypatch
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_is_left_to_jax(cache_setting):
    cache_setting.setenv("JAX_COMPILATION_CACHE_DIR", os.path.join(REPO, "elsewhere"))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == os.path.join(REPO, "elsewhere")
    assert jax.config.jax_compilation_cache_dir == before


def test_unset_env_var_uses_repo_cache(cache_setting):
    cache_setting.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert enable_compile_cache() == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == os.path.join(REPO, ".jax_cache")


def test_default_path_is_fixed_and_ignored(cache_setting):
    """The path is part of the cache key: no temp dir, pid or time in it, and
    git never commits what lands there."""
    cache_setting.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = enable_compile_cache()
    assert enable_compile_cache() == first == DEFAULT_CACHE_DIR
    assert not first.startswith(tempfile.gettempdir())
    assert str(os.getpid()) not in first
    with open(os.path.join(REPO, ".gitignore")) as fp:
        assert ".jax_cache/" in fp.read().split()
