"""The backend module: one place decides every platform-dependent
choice, an unknown platform raises, production never asks for Pallas
interpret mode, and the compile cache follows one rule."""

import os
import pathlib
import re

import jax
import pytest

from dis_tpu import backend
from dis_tpu.config import PRESETS

PKG = pathlib.Path(backend.__file__).parent


@pytest.mark.parametrize("platform", backend.PLATFORMS)
def test_choices_are_valid_forms(platform):
    c = backend.choices(platform)
    assert c.search in ("pallas", "xla")
    assert c.templates in ("slices", "twostage", "twostage_rw")
    assert c.resize in ("reshape", "window", "window2")


def test_cpu_never_runs_the_gpu_kernel():
    assert backend.choices("cpu").search == "xla"


@pytest.mark.parametrize("platform", backend.PLATFORMS)
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_search_kernel_per_preset(preset, platform):
    cfg = PRESETS[preset]
    assert (backend.search_kernel(cfg.kernel, platform)
            == backend.choices(platform).search)
    assert backend.search_kernel("xla", platform) == "xla"


def test_pallas_kernel_refused_off_gpu():
    assert backend.search_kernel("pallas", "gpu") == "pallas"
    with pytest.raises(ValueError, match="GPU"):
        backend.search_kernel("pallas", "cpu")


def test_unknown_platform_raises(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported"):
        backend.platform()
    with pytest.raises(RuntimeError, match="unsupported"):
        backend.choices()
    with pytest.raises(RuntimeError):
        backend.choices("metal")


def test_current_platform_is_cpu_here():
    assert backend.platform() == "cpu"


def test_only_backend_module_queries_the_platform():
    hits = [p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")
            if "default_backend()" in p.read_text()]
    assert hits == ["backend.py"], hits


def test_production_never_passes_interpret():
    """Interpret mode is for tests only: no package source turns it on."""
    for p in PKG.rglob("*.py"):
        src = p.read_text()
        assert not re.search(r"interpret\s*=\s*(True|jax\.|backend)", src), p


def test_compile_cache_default(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        d = backend.setup_compile_cache()
        assert d == os.path.join(PKG.parent, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_is_used_as_is(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    assert backend.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == old  # nothing set


def test_gitignore_lists_cache():
    lines = (PKG.parent / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines
