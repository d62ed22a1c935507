"""Where JAX keeps its persistent compilation cache for this checkout.

Whole-solve ``while_loop`` programs take tens of seconds to compile, so the
scripts and the test suite share JAX's on-disk cache.  The directory is
part of what makes a cache hit, so it never moves: either the one that
``JAX_COMPILATION_CACHE_DIR`` names, or ``.jax_cache/`` at the root of the
checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def configure_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache goes to the checkout's fixed
    ``.jax_cache/``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
