"""Persistent XLA compilation cache for the entry points.

A cold run of the flagship compiles the whole sweep scan; the persistent
cache lets the next process on the same machine load it instead. The cache
key includes the directory, so the path is fixed: ``<repo>/.jax_cache``
(git-ignored), never a temporary, per-process or per-run name.
"""

from __future__ import annotations

import os

import jax

__all__ = ["CACHE_DIR", "enable_compile_cache"]

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache before the first compile.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
    is changed; otherwise the cache goes to :data:`CACHE_DIR`. Returns the
    directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
