"""The persistent compile cache helper: JAX_COMPILATION_CACHE_DIR wins when
set (nothing else is set); otherwise a fixed directory in the checkout."""

import os

import jax

from project_desert_tortoise_tpu.utils import compile_cache as CC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _with_config(fn):
    old = jax.config.jax_compilation_cache_dir
    try:
        return fn()
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))

    def run():
        jax.config.update("jax_compilation_cache_dir", None)
        assert CC.enable_compile_cache() == str(tmp_path)
        # the helper set nothing: JAX reads the variable itself
        assert jax.config.jax_compilation_cache_dir is None
    _with_config(run)


def test_default_dir_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)

    def run():
        d = CC.enable_compile_cache()
        assert d == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d
    _with_config(run)
