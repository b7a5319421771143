"""utils/compile_cache: where the persistent compilation cache goes.

``JAX_COMPILATION_CACHE_DIR`` wins with nothing set in code; otherwise the
fixed ``<repo>/.jax_compile_cache``; never on the CPU backend (XLA:CPU
entries embed host machine features that are not part of the key).
"""

import os

import jax

from bert4clickpath.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    return calls


def test_env_var_honoured_with_no_override(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    calls = _record_updates(monkeypatch)
    assert compile_cache.enable(str(tmp_path / "other")) == str(tmp_path / "env")
    assert calls == []  # JAX reads the variable itself
    assert not (tmp_path / "other").exists()


def test_default_dir_is_fixed_inside_the_checkout():
    assert compile_cache.DEFAULT_DIR == os.path.join(REPO, ".jax_compile_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_compile_cache/" in f.read().split()


def test_accelerator_uses_the_default_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(compile_cache, "DEFAULT_DIR", str(tmp_path / "cache"))
    calls = _record_updates(monkeypatch)
    assert compile_cache.enable() == str(tmp_path / "cache")
    assert calls == [("jax_compilation_cache_dir", str(tmp_path / "cache"))]
    assert (tmp_path / "cache").is_dir()


def test_enable_skips_cpu_backend(tmp_path, monkeypatch):
    # conftest forces the CPU backend for the whole suite
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    assert compile_cache.enable(str(tmp_path / "cache")) is None
    assert calls == []
    assert not (tmp_path / "cache").exists()


def test_enable_respects_opt_out(tmp_path, monkeypatch):
    monkeypatch.setenv("B4CP_NO_COMPILE_CACHE", "1")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    calls = _record_updates(monkeypatch)
    assert compile_cache.enable(str(tmp_path / "cache")) is None
    assert calls == []
