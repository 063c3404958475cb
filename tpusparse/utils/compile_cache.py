"""The one place that points JAX's persistent compilation cache somewhere.

A cold 300^3 solve spends most of its wall time compiling, and the cache key
includes the directory, so the directory must not move between runs: it is
``$JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads it itself, so
nothing is configured here), else ``<checkout>/.jax_cache`` (listed in
``.gitignore``), with an optional fixed sub-directory.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = Path(__file__).resolve().parents[2]


def cache_dir(subdir: str | None = None) -> Path:
    """The directory ``enable_compile_cache(subdir)`` uses."""
    env = os.environ.get(ENV_VAR)
    if env:
        return Path(env)
    base = CHECKOUT / ".jax_cache"
    return base / subdir if subdir else base


def enable_compile_cache(subdir: str | None = None) -> Path:
    """Turn on the persistent compilation cache and return its directory.

    With ``$JAX_COMPILATION_CACHE_DIR`` set this changes no setting.
    Otherwise it sets the checkout-local directory and caches every
    compilation, however short.
    """
    import jax

    path = cache_dir(subdir)
    if os.environ.get(ENV_VAR):
        return path
    jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
