"""utils.runtime: the per-platform path table, the compilation-cache
directory rule, and chip_smoke.py's refusal to run without a GPU."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from mused_tpu.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_platform_paths_named_for_each_platform(platform):
    paths = runtime.platform_paths(platform)
    assert paths is runtime.PLATFORM_PATHS[platform]
    assert paths.windows_per_batch >= 1
    assert all(isinstance(getattr(paths, f), bool)
               for f in ("binned_select", "cand_fold", "device_hdbscan"))


def test_platform_paths_cpu_keeps_plain_paths():
    """The CPU runs per-window dispatch, strip selection, the dense fold
    and host HDBSCAN; the default platform is JAX's backend (the CPU
    here)."""
    assert runtime.platform_paths() == runtime.platform_paths("cpu") == \
        runtime.PlatformPaths(windows_per_batch=1, binned_select=False,
                              cand_fold=False, device_hdbscan=False)


def test_platform_paths_unknown_platform_is_an_error():
    with pytest.raises(ValueError, match="rocm"):
        runtime.platform_paths("rocm")


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compilation_cache_dir() == str(tmp_path)


def test_cache_dir_default_is_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert runtime.compilation_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_cache_disabled_by_env(monkeypatch):
    monkeypatch.setenv("MUSED_TPU_NO_COMPILE_CACHE", "1")
    assert runtime.enable_compilation_cache() is None


def test_cache_lands_in_env_dir_with_no_fingerprint(tmp_path):
    """A fresh process with JAX_COMPILATION_CACHE_DIR set writes its
    entries straight into that directory (no per-host subdirectory) and
    nothing into the checkout's default."""
    code = ("import jax, jax.numpy as jnp\n"
            "from mused_tpu.utils.runtime import enable_compilation_cache\n"
            "print(enable_compilation_cache())\n"
            "jax.config.update('jax_persistent_cache_min_compile_time_secs',"
            " 0)\n"
            "jax.jit(lambda x: jnp.sin(x) @ x.T)(jnp.ones((8, 8)))"
            ".block_until_ready()\n")
    env = {k: v for k, v in os.environ.items()
           if k != "MUSED_TPU_NO_COMPILE_CACHE"}
    env.update(JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    before = os.listdir(os.path.join(REPO, ".jax_cache")) \
        if os.path.isdir(os.path.join(REPO, ".jax_cache")) else None
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == str(tmp_path)
    entries = os.listdir(tmp_path)
    assert entries and all(os.path.isfile(tmp_path / e) for e in entries)
    after = os.listdir(os.path.join(REPO, ".jax_cache")) \
        if os.path.isdir(os.path.join(REPO, ".jax_cache")) else None
    assert before == after


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_cpu_only_host(tmp_path, alone):
    """With no GPU — from the checkout, or alone in an empty directory —
    chip_smoke.py exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            assert "ok" not in json.loads(line)
        except json.JSONDecodeError:
            pass
