"""Where JAX keeps its persistent compilation cache.

Entry points (``cli.main``, ``bench.py``, ``chip_smoke.py``,
``benchmarks/run_benchmarks.py``) call ``enable()`` before they compile.
JAX itself reads ``JAX_COMPILATION_CACHE_DIR``; when it is set, that
directory is used and nothing else is set.  Otherwise the cache goes to
``.jax_cache/`` at the root of the checkout: a fixed path, because the
path is part of the cache key and a directory that moves never hits.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compilation cache at its directory."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
