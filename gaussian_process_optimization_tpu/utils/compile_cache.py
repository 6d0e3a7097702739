"""Location of JAX's persistent compilation cache.

One rule for every entry point (``chip_smoke.py``, ``bench.py``, the
``benchmarks/`` scripts): where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing is set here; otherwise the cache lives at ``<repo>/.jax_cache``,
a fixed path, so that later runs from the same checkout find what earlier ones
compiled.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(environ=None) -> tuple[str, bool]:
    """(directory, whether it comes from the environment)."""
    environ = os.environ if environ is None else environ
    env = environ.get(ENV_VAR)
    if env:
        return env, True
    return str(REPO_CACHE), False


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at `cache_dir()` and return the directory."""
    path, from_env = cache_dir()
    if not from_env:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
