"""Persistent XLA compilation cache configuration.

A canonical solve compiles hundreds of executables once and then reuses
them every Picard iteration; JAX's persistent compilation cache keys
executables on (HLO, compile options, backend), so re-running the same
configuration skips straight to execution. Chombo has no analogue (C++
compiles ahead of time); this is the counterpart of simply *having* a
compiled binary on disk.

The cache lives where `JAX_COMPILATION_CACHE_DIR` says when it is set (JAX
reads that variable itself), and otherwise at `<repo>/.jax_cache` — a fixed
path inside the checkout, since the path is part of the cache key.
"""

from __future__ import annotations

import os

import jax

_ENV = "JAX_COMPILATION_CACHE_DIR"
_DEFAULT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory configure() uses."""
    return os.environ.get(_ENV) or _DEFAULT


def configure() -> str:
    """Point JAX's persistent compilation cache at cache_dir(). Safe to
    call more than once."""
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    # cache everything that took meaningful compile time; the default
    # (1 s) would skip the hundreds of small per-depth executables whose
    # *sum* dominates the wall clock
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    return path
