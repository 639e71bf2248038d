"""Where JAX keeps its persistent compilation cache.

Entry points (``bench.py``, ``chip_smoke.py``, ``benchmarks/*``) call
:func:`enable_compile_cache` once before their first compile, so that every
process of one checkout shares compiled programs.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

# Fixed path inside the checkout (listed in .gitignore): the cache is keyed
# on its directory, so a path that moved between runs would never hit.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it: leave it
    alone and set no other path.  Otherwise use :data:`DEFAULT_DIR`."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
