"""Where JAX keeps its persistent compilation cache for this repository."""

import os
import pathlib

import jax

REPO_CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"
"""The fixed default: ``<repo>/.jax_cache`` (listed in ``.gitignore``)."""


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it, and no
    other directory is set here. Otherwise the cache goes to
    :data:`REPO_CACHE_DIR`, a fixed path, since the path is part of the
    cache's key and a directory that moves never hits.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(REPO_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
