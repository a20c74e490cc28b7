"""Persistent compilation cache for the repository's scripts.

The library itself never configures a cache; entry-point scripts call
:func:`use_compile_cache` once, before their first compilation.
"""

from __future__ import annotations

import os

__all__ = ["use_compile_cache", "CHECKOUT_CACHE_DIR"]

#: ``<checkout>/.jax_cache``: the default cache directory (git-ignored).
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def use_compile_cache() -> str:
    """Keep JAX's persistent compile cache in ``$JAX_COMPILATION_CACHE_DIR``
    when that is set (JAX reads the variable itself, so nothing is
    changed), else in :data:`CHECKOUT_CACHE_DIR`. Returns the directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return CHECKOUT_CACHE_DIR
