"""Persistent XLA compile cache location.

Called by entry points (the server's ``main``, ``chip_smoke.py``), never at import, so
library users and tests keep JAX's own settings.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Use ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself, so
    nothing is set here); otherwise a fixed ``<checkout>/.jax_cache``.  A fixed path
    matters: the directory is part of what a later process must find again.
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
