"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (CLI, bench, chip_smoke.py, tools, tests):
``JAX_COMPILATION_CACHE_DIR`` when it is set, and otherwise ``.jax_cache/``
at the root of the checkout. The path is part of the cache key, so it is
fixed rather than temporary; ``.gitignore`` lists it.
"""

from __future__ import annotations

import os
import sys

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def cache_dir() -> str:
    """The directory the cache lives in (the env var wins)."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable() -> str:
    """Point this process (and the processes it starts) at the cache.

    Safe before or after ``import jax``: the env var covers a later import
    and child processes, the config update covers an already imported JAX.
    """
    path = cache_dir()
    os.environ[ENV] = path
    if "jax" in sys.modules:
        sys.modules["jax"].config.update("jax_compilation_cache_dir", path)
    return path
