"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, wins and no other directory is set
in code. Otherwise the cache lives at one fixed path inside the checkout
(``.jax_cache/``, git-ignored): the path is part of the cache key, so a
directory that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["REPO_ROOT", "compile_cache_dir", "enable_compile_cache"]

REPO_ROOT = Path(__file__).resolve().parents[2]


def compile_cache_dir(environ=None) -> str:
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_ROOT / ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX at :func:`compile_cache_dir`; returns the directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
