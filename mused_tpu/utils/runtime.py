"""Runtime setup shared by the CLI, bench, and driver entry points: the
persistent compilation cache and the one table of per-platform paths."""
from __future__ import annotations

import os
from typing import NamedTuple

# the checkout root (the directory holding the mused_tpu package): the
# default cache lives at a FIXED path there — the cache directory is part of
# every entry's key, so a directory that moves between runs never hits
CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compilation_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    (listed in .gitignore)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT_DIR, ".jax_cache"))


def enable_compilation_cache() -> str | None:
    """Turn on JAX's persistent compilation cache at
    :func:`compilation_cache_dir` and return that directory.

    ``MUSED_TPU_NO_COMPILE_CACHE=1`` disables it (returns None).  The test
    suite sets it (tests/conftest.py): at whole-suite scale on the CPU
    backend, XLA's ``executable.serialize()`` segfaults after hundreds of
    compilations (jax 0.9.0, any codec) — and the CLI under test calls this
    helper, which would otherwise switch the cache on mid-suite."""
    if os.environ.get("MUSED_TPU_NO_COMPILE_CACHE"):
        return None
    import jax
    path = compilation_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


class PlatformPaths(NamedTuple):
    """The engine's default path on one platform, for every choice the
    config leaves on auto (None).  An explicit config value always wins.

    windows_per_batch  scanned multi-window dispatch width W for eligible
                       tumbling streams, offline and serving (1 = one
                       dispatch per window); PipelineConfig.windows_per_batch
    binned_select      huge-window stride-binned candidate selection
                       instead of the (block, n) strip + approx_max_k;
                       PipelineConfig.huge_window_fused_select
    cand_fold          huge-window SWFDMC absorbs candidate-form blocks
                       instead of dense (block, n) blocks;
                       PipelineConfig.huge_window_cand_fold
    device_hdbscan     HDBSCAN above the dense-Prim cap runs the device
                       Boruvka (ops/blocked_hdbscan) instead of host Prim
    """

    windows_per_batch: int
    binned_select: bool
    cand_fold: bool
    device_hdbscan: bool


PLATFORM_PATHS = {
    # the CPU backend: plain per-window dispatch and the strip/dense
    # huge-window paths (the binned emulation saves nothing there)
    "cpu": PlatformPaths(windows_per_batch=1, binned_select=False,
                         cand_fold=False, device_hdbscan=False),
    # NVIDIA H100 — each choice timed both ways on the card (PERF.md)
    "gpu": PlatformPaths(windows_per_batch=8, binned_select=True,
                         cand_fold=True, device_hdbscan=True),
}


def platform_paths(platform: str | None = None) -> PlatformPaths:
    """The :class:`PlatformPaths` of ``platform`` (default: JAX's default
    backend).  A platform with no entry is an error, not a default."""
    if platform is None:
        import jax
        platform = jax.default_backend()
    try:
        return PLATFORM_PATHS[platform]
    except KeyError:
        raise ValueError(
            f"no engine paths for platform {platform!r}: expected one of "
            f"{sorted(PLATFORM_PATHS)}") from None
