"""Persistent compilation cache placement (observe.enable_compilation_cache)."""

import os

import jax

from nanocall_tpu import observe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_env_var_leaves_config_alone(monkeypatch, tmp_path):
    """JAX reads JAX_COMPILATION_CACHE_DIR itself: no other dir is set."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    observe.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_default_is_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        observe.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            REPO, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
