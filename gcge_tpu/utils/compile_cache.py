"""Where JAX keeps its persistent compile cache for scripts of this checkout.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` by itself.  When that variable is
set, :func:`use_compile_cache` sets nothing, so the cache lands exactly
there.  Otherwise it points the cache at ``<checkout>/.jax_cache``, a fixed
path derived from this file's location (the path is part of the cache key,
so a directory that moves never hits).
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
ENV = "JAX_COMPILATION_CACHE_DIR"


def use_compile_cache() -> str:
    """Enable the persistent compile cache; return the directory in use."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
