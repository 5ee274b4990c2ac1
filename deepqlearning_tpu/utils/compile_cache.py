"""Where entry points keep JAX's persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, decides: JAX reads it itself and
nothing is set in code. Otherwise the cache goes to ``.jax_cache`` at the
root of the checkout this file belongs to. The path is fixed because it is
part of the cache key: a directory that moves between runs never hits.
"""
from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns it."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
