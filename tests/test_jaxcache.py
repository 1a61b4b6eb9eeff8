"""Persistent compilation cache location (utils/jaxcache.py)."""

import os
import sys

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from x264_tpu.utils import jaxcache  # noqa: E402


def test_env_var_is_left_to_jax(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxcache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_one_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        first = jaxcache.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == first
        assert jaxcache.enable_compile_cache() == first
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert first == os.path.join(ROOT, ".jax_cache")
    # the directory is never committed
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
