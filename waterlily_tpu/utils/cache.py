"""Persistent XLA compilation cache helper.

Whole-step programs for big 3D grids can take minutes to compile; JAX's
persistent cache makes every later process reuse the compiled executable.
Called by bench.py, chip_smoke.py, the tests and the examples; library
import stays side-effect free.
"""
from __future__ import annotations

import os

import jax

__all__ = ["enable_compile_cache", "cache_dir"]

# the fixed fallback: the path is part of the cache key, so it must not move
_DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_DIR


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Enable the on-disk XLA compilation cache at `cache_dir` (idempotent)."""
    directory = cache_dir()
    os.makedirs(directory, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", directory)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return directory
