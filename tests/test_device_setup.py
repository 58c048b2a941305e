"""Device set-up: compile-cache placement, platform and failure recording."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from conftest import require_vocab
from tokenizer_tpu.runtime import jaxenv

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def config_calls(monkeypatch):
    """Record jax.config.update calls instead of applying them, and let
    ensure_compile_cache run again."""
    import jax

    calls = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.__setitem__(k, v))
    monkeypatch.setattr(jaxenv, "_done", False)
    monkeypatch.delenv("TOKENIZER_TPU_NO_COMPILE_CACHE", raising=False)
    return calls


def test_compile_cache_uses_env_dir(config_calls, monkeypatch, tmp_path):
    target = tmp_path / "cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    jaxenv.ensure_compile_cache()
    assert config_calls["jax_compilation_cache_dir"] == str(target)
    assert target.is_dir()


def test_compile_cache_default_is_fixed_in_checkout(config_calls, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jaxenv.ensure_compile_cache()
    assert config_calls["jax_compilation_cache_dir"] == str(REPO / ".jax_cache")
    assert jaxenv.compile_cache_dir() == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


def test_compile_cache_unusable_dir_warns_not_raises(config_calls, monkeypatch, tmp_path):
    """A default directory that cannot be created (here: under a file)
    leaves the cache off with a warning instead of failing the caller."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    blocker = tmp_path / "site-packages"
    blocker.write_text("")
    monkeypatch.setattr(jaxenv, "DEFAULT_CACHE_DIR", blocker / ".jax_cache")
    with pytest.warns(RuntimeWarning, match="without a persistent cache"):
        jaxenv.ensure_compile_cache()
    assert "jax_compilation_cache_dir" not in config_calls


def test_compile_cache_off_outside_checkout(config_calls, monkeypatch, tmp_path):
    """An installed package (no pyproject.toml above it) with no env dir
    writes no cache into site-packages."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jaxenv, "_CHECKOUT", tmp_path)
    assert jaxenv.compile_cache_dir() is None
    with pytest.warns(RuntimeWarning, match="no source checkout"):
        jaxenv.ensure_compile_cache()
    assert config_calls == {}
    assert list(tmp_path.iterdir()) == []


@pytest.fixture
def tok():
    require_vocab("gpt2")
    from tokenizer_tpu import create_by_encoder_name

    return create_by_encoder_name(
        "gpt2", allow_fetch=False, use_tpu=True, mesh=None
    )


def test_device_platform_recorded(tok):
    assert tok.device_platform is None
    tok._ensure_device()
    assert tok.device_platform == "cpu"
    assert tok.device_error is None


def test_failed_probe_is_recorded_not_swallowed(tok, monkeypatch):
    def boom():
        raise RuntimeError("no device here")

    monkeypatch.setattr(tok, "_ensure_device", boom)
    tok._start_channel_probe()
    assert tok._probe_thread_done.wait(30)
    assert "channel probe" in tok.device_error
    assert "no device here" in tok.device_error
    assert not tok._dev_ready
    # The host route keeps serving.
    from tokenizer_tpu import create_by_encoder_name

    host = create_by_encoder_name("gpt2", allow_fetch=False)
    docs = [f"word{i} and more words {i * 7}" for i in range(50)]
    assert [list(x) for x in tok.encode_batch(docs)] == [host.encode(d) for d in docs]


def test_failed_prearm_is_recorded_and_warned(tok, monkeypatch, tmp_path):
    monkeypatch.setenv("TOKENIZER_TPU_CACHE_DIR", str(tmp_path))
    (tmp_path / "wave_shapes.json").write_text(json.dumps([[[16, 128]]]))

    def broken(shapes, record=True):
        raise RuntimeError("compile refused")

    monkeypatch.setattr(tok, "_wave_fn", broken)
    with pytest.warns(RuntimeWarning, match="compile refused"):
        tok._prearm_wave_fns()
    assert tok.device_error.startswith("pre-arm compile: ")
