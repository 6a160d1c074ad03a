"""Persistent XLA compile cache for the GPU entry scripts
(`chip_smoke.py`, `bench.py`). Not called on import of `ibx`: library
users keep JAX's own settings.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is left to JAX. Otherwise the
    cache lives at the fixed ``<repo>/.jax_cache`` (gitignored): the path is
    part of the cache key, so it must not move between runs.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
