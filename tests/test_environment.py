"""Run-time environment of the package: where the compile cache lives, and
what the main path needs to import."""

import os
import subprocess
import sys

import pytest

from stereo_reconstruction.utils import compile_cache

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_compile_cache_default_is_fixed_inside_the_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    assert compile_cache.cache_dir() == compile_cache.DEFAULT_DIR
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_honours_the_env_var(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    try:
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        assert os.environ[compile_cache.ENV] == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_no_other_cache_path_in_code():
    """Every entry point goes through the helper (no hard-coded cache)."""
    out = subprocess.run(
        ["git", "grep", "-n", "-e", "jax_compilation_cache_dir",
         "-e", "JAX_COMPILATION_CACHE_DIR", "--", "*.py", ":!tests"],
        cwd=REPO, capture_output=True, text=True)
    if out.returncode not in (0, 1):
        pytest.skip("not a git checkout")
    files = {ln.split(":")[0] for ln in out.stdout.splitlines()}
    assert files <= {"stereo_reconstruction/utils/compile_cache.py"}, files


@pytest.mark.parametrize("module", ["stereo_reconstruction.pipeline",
                                    "stereo_reconstruction.pipeline_batch"])
def test_main_path_imports_without_pil(module):
    code = ("import sys; sys.modules['PIL'] = None; "
            f"import {module}; "
            "from stereo_reconstruction.data.synthetic import make_scene; "
            "assert 'PIL.Image' not in sys.modules")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
