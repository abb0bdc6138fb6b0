"""Persistent XLA compile cache shared by the entry points.

JAX keys cached executables by path among other things, so the directory
must not move between runs: ``JAX_COMPILATION_CACHE_DIR`` when it is set
(JAX reads it itself, and nothing is set here), else the fixed
``<checkout>/.jax_cache`` (gitignored).
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns the directory in use."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
