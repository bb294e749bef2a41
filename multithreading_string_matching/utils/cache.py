"""Persistent XLA compilation cache location."""

from __future__ import annotations

import os
import pathlib

# A fixed path: the cache directory is part of each entry's key, so a
# directory that moves between runs never hits.
CHECKOUT_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> None:
    """Keep compiled executables across processes: in
    ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself and
    no other directory is set here), otherwise in ``<checkout>/.jax_cache``."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
