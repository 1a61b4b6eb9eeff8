"""Persistent XLA compilation cache location.

A cold process compiles every stage program of the encoder; the
persistent cache lets the next process on the same machine skip that.
The cache key includes the directory, so the directory must not move
between runs.
"""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    is changed here. Otherwise the cache goes to `.jax_cache/` at the root
    of the checkout (gitignored), the same path on every call."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
