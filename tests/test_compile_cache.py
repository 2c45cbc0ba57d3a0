"""The persistent compilation cache: JAX_COMPILATION_CACHE_DIR wins when set,
otherwise a fixed, git-ignored directory in the repository."""

import os

import jax
import pytest

from theano_pyglm_tpu.utils.compile_cache import CACHE_DIR, enable_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_is_left_to_jax(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_fixed_repo_path_when_unset(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert CACHE_DIR == want
    assert enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert enable_compile_cache() == want  # the same path on every call


def test_cache_dir_is_git_ignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
