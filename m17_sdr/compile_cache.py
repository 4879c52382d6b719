"""Where JAX keeps its persistent compilation cache.

The RX pipeline's compile takes tens of seconds; the cache lets a later
process of the same checkout skip it.  When `JAX_COMPILATION_CACHE_DIR`
is set, JAX reads it itself and nothing is set here.  Otherwise the
cache lives at a fixed path inside the checkout: the path is part of
the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os
import pathlib

CHECKOUT_CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
