"""JAX's persistent compilation cache, kept at one fixed place.

Command-line entry points call ``enable_compile_cache()`` before their
first compile; importing the package does not, so tests write no cache.
A cache's path is part of its key, so the default never depends on a
temporary name, a process id or the time.
"""
from __future__ import annotations

import os
import pathlib

import jax

DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Use ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself; nothing is set here), else ``<repo>/.jax_cache``.  Returns
    the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
