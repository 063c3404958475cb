"""Where the persistent compilation cache lives: $JAX_COMPILATION_CACHE_DIR
when set (and then nothing is configured), else a fixed directory inside the
checkout — never a temporary or per-process path."""

import tempfile
from pathlib import Path

import jax
import pytest

from tpusparse.utils import compile_cache as cc

_KEYS = ("jax_compilation_cache_dir",
         "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture
def restore_config():
    saved = {k: getattr(jax.config, k) for k in _KEYS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_env_var_wins_and_sets_nothing(monkeypatch, restore_config,
                                       tmp_path):
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path / "c"))
    before = {k: getattr(jax.config, k) for k in _KEYS}
    assert cc.enable_compile_cache() == tmp_path / "c"
    assert cc.enable_compile_cache("sub") == tmp_path / "c"
    assert {k: getattr(jax.config, k) for k in _KEYS} == before


@pytest.mark.parametrize("subdir", [None, "pytest_abc"])
def test_default_is_fixed_checkout_path(monkeypatch, restore_config, subdir):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    path = cc.enable_compile_cache(subdir)
    want = Path(__file__).resolve().parents[1] / ".jax_cache"
    assert path == (want / subdir if subdir else want)
    assert jax.config.jax_compilation_cache_dir == str(path)
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
    # the same path on every call, and none under the temp directory
    assert cc.cache_dir(subdir) == path
    assert not path.is_relative_to(Path(tempfile.gettempdir()).resolve())


def test_cache_dir_is_gitignored():
    ignore = (cc.CHECKOUT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignore
