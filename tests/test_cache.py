# test_cache.py — where the compilation cache and its neighbours live.
import os

import jax
import pytest

from reasoning_image_generation_tpu.utils import aot, cache

from .conftest import REPO_ROOT


@pytest.fixture()
def restore_cache_config():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_default_cache_dir_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.cache_dir() == str(REPO_ROOT / ".jax_cache")
    assert aot.aot_dir() == str(REPO_ROOT / ".jax_cache" / "aot")


def test_env_cache_dir_is_honoured(monkeypatch, tmp_path,
                                   restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    cache.enable_compilation_cache()
    # JAX reads the variable itself; nothing is set in code
    assert jax.config.jax_compilation_cache_dir is None
    assert cache.cache_dir() == str(tmp_path)
    assert aot.aot_dir() == os.path.join(str(tmp_path), "aot")
    cache.save_run_stats("probe", {"a": 2.0})
    assert os.path.exists(tmp_path / "runstats_probe.json")


def test_default_cache_dir_is_set_without_env(monkeypatch,
                                              restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    cache.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == cache.default_cache_dir()


def test_run_stats_write_errors_are_not_swallowed(monkeypatch, tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    monkeypatch.setattr(cache, "cache_dir", lambda: str(blocker))
    with pytest.raises(OSError):
        cache.save_run_stats("x", {"a": 1.0})
