"""Persistent XLA compilation cache at a fixed path.

A cold flagship compile takes minutes, and JAX keys its persistent cache by
the directory, so the directory must not move between runs: it is never
built from a temporary name, a pid or the time.
"""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache`` (listed in .gitignore)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(os.path.dirname(here)), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here. Otherwise the cache goes to
    :func:`default_cache_dir`. Call before the first compile.
    """
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
