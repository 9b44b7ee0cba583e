"""Where JAX's persistent compilation cache lives (utils/compile_cache.py)."""

import os
import subprocess

import jax

from bfqzip_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_environment_variable_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)


def test_default_is_fixed_inside_checkout_and_ignored(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.compile_cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    assert compile_cache.compile_cache_dir() == path  # no per-run name
    r = subprocess.run(["git", "check-ignore", "-q", path], cwd=REPO)
    assert r.returncode == 0, ".jax_cache/ must be listed in .gitignore"


def test_enable_points_jax_at_the_cache(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
