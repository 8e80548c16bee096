"""Persistent XLA compilation cache location.

One rule for every entry point (CLI, ``bench.py``, ``chip_smoke.py``): when
``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and nothing is set
here; otherwise the cache lives in ``.jax_cache/`` at the root of the
checkout (git-ignored). The path is part of the cache key, so it is fixed
rather than derived from the working directory.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent compile cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`cache_dir`; returns it."""
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return cache_dir()
