"""Persistent XLA compile cache shared by the program's entry points.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache directory and JAX
reads it itself; nothing else is set in code then.  Otherwise the cache goes
to the fixed ``.jax_cache/`` directory of the checkout: the path is part of
what makes a later process find an earlier one's programs, so it never
contains a temporary name, a process id or the time.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory → that path."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
