"""Persistent compile cache for the entry points that run on the GPU.

A cold process recompiles every 1000-sub-step interval program; the cache
keeps what one run compiled for the next. Entry points (``chip_smoke.py``,
``bench*.py``, ``examples/``) call :func:`enable_compile_cache` once, before
their first compile. Importing the package sets nothing.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

# fixed, so that every run of this checkout finds the same entries (the
# cache's key includes its path)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> Optional[str]:
    """Where compiled programs are cached, or None.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and this
    sets nothing. Otherwise, on the GPU, the cache goes to ``.jax_cache`` at
    the root of the checkout. CPU runs (tests, rehearsals) keep no cache.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    from pdecontrolgym_jax.ops.backend import platform

    if platform() != "gpu":
        return None
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
