"""Persistent compilation cache placement (one policy for every launcher)."""
from __future__ import annotations

import os

__all__ = ["enable_compile_cache", "REPO_CACHE_DIR"]

# <checkout>/.jax_cache: a fixed path (the path is part of the cache key),
# listed in .gitignore
REPO_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
    else is set here; otherwise the cache goes to ``<checkout>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
