"""JAX's persistent compilation cache, in one place.

A DVB-S2-size decode compiles for tens of seconds; the cache lets a second
process (the next sweep, bench or smoke run) load the compiled programs
instead.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it by itself
and nothing else is set here.  Otherwise the cache lives in ``.jax_cache/``
at the root of the checkout: a fixed path, because the directory is part of
what a cached entry is found under.
"""

from __future__ import annotations

import os

import jax

__all__ = ["CACHE_ENV", "DEFAULT_CACHE_DIR", "enable_compile_cache"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; return its directory."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
