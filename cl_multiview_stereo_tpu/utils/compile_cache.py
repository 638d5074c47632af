"""Persistent compilation cache at a fixed place.

Every entry point (``cli.main``, ``bench.py``, ``chip_smoke.py``) calls
``configure_compile_cache`` before its first compile.  A fresh process then
finds the programs an earlier process in the same checkout compiled.  The
cache path is part of the cache's key, so it never moves: it is
``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads it itself), and
otherwise ``<checkout>/.jax_cache``, which git ignores.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent cache at its fixed directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
