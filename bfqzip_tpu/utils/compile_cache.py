"""JAX's persistent compilation cache: one place decides where it lives.

Wide variadic sorts take tens of seconds to compile, so every entry point
(the CLI, bench.py, chip_smoke.py, the tools) keeps compiled programs on
disk.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, that directory is used and
nothing else is set; otherwise the cache is ``<checkout>/.jax_cache``, a fixed
path (the path is part of the cache key, so a moving directory never hits)
that ``.gitignore`` lists.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """The environment's cache directory if set, else the checkout's."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir()."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
