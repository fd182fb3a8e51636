"""Compile-cache placement and the GPU requirement of the GPU entry points."""

import jax
import pytest

from racing_slam_tpu.utils import runtime

_KEYS = (
    "jax_compilation_cache_dir",
    "jax_persistent_cache_min_entry_size_bytes",
    "jax_persistent_cache_min_compile_time_secs",
)


@pytest.fixture
def restore_cache_config():
    saved = {k: getattr(jax.config, k) for k in _KEYS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cache_env_var_is_used_and_nothing_set(monkeypatch, tmp_path,
                                               restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = {k: getattr(jax.config, k) for k in _KEYS}
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert {k: getattr(jax.config, k) for k in _KEYS} == before


def test_cache_defaults_to_fixed_gitignored_dir(monkeypatch,
                                               restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = runtime.enable_compile_cache()
    assert first == runtime.enable_compile_cache()  # fixed, not per process
    assert jax.config.jax_compilation_cache_dir == first
    repo = runtime.DEFAULT_CACHE_DIR.parent
    assert runtime.DEFAULT_CACHE_DIR.name == ".jax_cache"
    assert (repo / "racing_slam_tpu").is_dir()  # inside the checkout
    ignored = (repo / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored, ".jax_cache is not in .gitignore"


def test_require_gpu_fails_on_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.require_gpu()
