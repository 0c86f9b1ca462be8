"""Test harness: run everything on a virtual 8-device CPU mesh.

`JAX_PLATFORMS` defaults to the CPU here and
`xla_force_host_platform_device_count` gives 8 fake devices, so the
`jax.sharding` paths are exercised deterministically (SURVEY.md §4).  Must
run before the first `import jax`.  Tests marked ``gpu`` need the card:
they skip here and run in `python chip_smoke.py` on a GPU host.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

import numpy as np
import pytest

# Persistent compilation cache: DO NOT enable it for the test suite.
# The full suite segfaults at whole-suite scale (~86-88%, always inside
# test_swfd.py's scan-heavy jits) during cache writes — the crash site is
# `executable.serialize()` in compilation_cache.put_executable_and_time
# (jax 0.9.0, CPU backend, 8 virtual devices).  It reproduces with the
# default zstd codec AND with the pure-zlib fallback, and with
# jax_persistent_cache_enable_xla_caches on or off, so the corruption is in
# XLA's executable serialization after hundreds of compilations, not in the
# compression codec.  Individual files pass with the cache on; only the
# whole suite crashes.  CPU compiles are cheap — run without the cache.
# Crucially the env var below also stops mused_tpu.main.cli() (under
# test_driver.py) from calling utils.runtime.enable_compilation_cache and
# switching the cache ON mid-suite — exactly how the crash kept coming back
# after the conftest itself stopped configuring a cache dir.
os.environ["MUSED_TPU_NO_COMPILE_CACHE"] = "1"

# Second whole-suite-scale crash mode: even with every cache disabled, XLA's
# CPU backend segfaults INSIDE backend_compile_and_load at ~86-88% of the
# suite (again test_swfd.py's scan jits; reproduced with the native C++
# extensions force-disabled via MUSED_TPU_NO_NATIVE=1, so it is not our
# code corrupting the heap).  The trigger is accumulation — hundreds of
# live compiled executables in one process.  Bound it: drop every compiled
# function periodically; recompiles are cheap on CPU.
_FLUSH_EVERY = 48
_done = {"n": 0}


def pytest_runtest_teardown(item, nextitem):
    _done["n"] += 1
    if _done["n"] % _FLUSH_EVERY == 0:
        jax.clear_caches()


def pytest_collection_modifyitems(config, items):
    """`-m fast` = everything not marked slow: a ~5 min sweep (measured
    310 s for 279/364 tests, round 4) touching every module, so the full
    (~18 min) suite stays a deliberate choice rather than the only option
    (VERDICT r3 next #8).  The slow marks come from a full-suite
    `--durations` run: every test function whose call measured >= ~3.7 s
    (the 80-deepest tail, ~710 s of the 1076 s total), whole parameterized
    families marked together; test_demo_golden stays fast deliberately
    (the golden pin is high value per second)."""
    for item in items:
        if "slow" not in item.keywords:
            item.add_marker(pytest.mark.fast)


@pytest.fixture
def rng():
    return np.random.default_rng(0)
