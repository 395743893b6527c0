"""Persistent XLA compile cache shared by every entry point."""
from __future__ import annotations

import os
from pathlib import Path

import jax

#: Cache directory used when JAX_COMPILATION_CACHE_DIR is not set: a fixed
#: path inside the checkout (the path is part of the cache key, so it must
#: not move between runs).
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is overridden; otherwise the cache goes to DEFAULT_CACHE_DIR.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
