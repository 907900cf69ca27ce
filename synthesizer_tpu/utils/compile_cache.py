"""Persistent XLA compilation cache for the program's entry points.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set, that
directory is the cache and nothing else is configured.  Otherwise the
cache lives in one fixed directory of the checkout (``.jax_cache``,
listed in ``.gitignore``): the path is part of what a later run looks up,
so it never carries a temporary name, a process id or a time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def compile_cache_dir() -> str:
    """The cache directory the entry points use."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir` (call it
    before the first compilation) and return the directory."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path
