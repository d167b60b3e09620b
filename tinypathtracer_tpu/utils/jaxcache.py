"""Persistent compile cache for the scripts at the repository root."""

from __future__ import annotations

import os

import jax

# One fixed directory inside the checkout (listed in .gitignore): the
# path is part of the cache key, so it must not move between runs.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def use_compile_cache() -> None:
    """Keep compiled programs across processes: in the directory that
    JAX_COMPILATION_CACHE_DIR names when it is set (JAX reads it
    itself), else in CACHE_DIR."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
