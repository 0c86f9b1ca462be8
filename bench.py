"""Benchmark: SWFD sketch update throughput, device vs reference-style CPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Headline metric (BASELINE.md config #1 regime): streaming sliding-window
Frequent-Directions updates/sec at d=1024, ell=64, window=2048 — the engine's
actual sketch path (fd.fold_sketch scanned FD fold + swfd ring absorb
+ per-window query).  Baseline: the reference's consumption pattern — a
per-row Python ``swfd.fit(row)`` loop over a NumPy FD implementation
(reference main.py:65-67) — measured on this host's CPU.

Timing note: results are materialized with np.asarray.  Per-window sketches
are consumed on-device; only the final state is pulled to host, so the stream
is pipelined like the real engine's async dispatch.  Needs a GPU: with no
accelerator it exits non-zero instead of timing the CPU.
"""
from __future__ import annotations

import json
import time

import numpy as np


def numpy_rowwise_fd(rows: np.ndarray, ell: int) -> float:
    """Reference-style baseline: per-row Python FD updates (SVD shrink when
    the 2*ell buffer fills).  Returns wall seconds."""
    d = rows.shape[1]
    buf = np.zeros((2 * ell, d), np.float32)
    fill = 0
    t0 = time.perf_counter()
    for i in range(rows.shape[0]):
        row = rows[i, :].reshape(1, -1)     # the reference's per-row reshape
        if fill == 2 * ell:
            _, s, vt = np.linalg.svd(buf, full_matrices=False)
            delta = s[ell] ** 2
            s2 = np.sqrt(np.maximum(s * s - delta, 0.0))
            buf = s2[:, None] * vt
            fill = ell
        buf[fill] = row[0]
        fill += 1
    return time.perf_counter() - t0


def require_gpu():
    """The accelerator this bench measures; exits non-zero without one."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU found (jax platform {dev.platform!r}); "
                         "this benchmark measures the accelerator only")
    return dev


def main():
    import jax
    from mused_tpu.utils.runtime import enable_compilation_cache
    enable_compilation_cache()
    import jax.numpy as jnp
    dev = require_gpu()

    from mused_tpu.ops import fd, swfd

    d, ell, window = 1024, 64, 2048
    n_windows = 32
    n_bench = window * n_windows
    rng = np.random.default_rng(0)
    # adjacency-like stream: binary sparse rows, the fused-matrix regime the
    # engine actually sketches (~k edges per row)
    rows = (rng.random((n_bench, d)) < 0.05).astype(np.float32)
    windows = jnp.asarray(rows.reshape(n_windows, window, d))

    # the engine's whole-window summary mode: "subspace" resolves to the
    # Gram-free Rayleigh-Ritz shrink for fold-scale stacks (engine
    # _window_step_impl does the same; docs/fd_roofline.md for the history:
    # eigh ~128k rows/s -> NS subspace ~861k -> implicit rr ~1.1M)
    mode = fd.resolve_fold_mode("subspace")

    @jax.jit
    def stream_step(state, w):
        st = fd.update_stream(fd.init(ell, d), w, mode=mode)
        state = swfd.absorb_summary(state, st.sketch, jnp.int32(window),
                                    st.sq_frobenius)
        sketch, _, _, _ = swfd.query(state, window=window, sketch_dim=ell)
        return state, sketch

    @jax.jit
    def run(ws):
        state = swfd.init(window, d, ell, block_rows=window)
        state, sketches = jax.lax.scan(stream_step, state, ws)
        return sketches

    np.asarray(run(windows)[-1])                # compile + warm
    # Best of 4 spaced trials; per-trial reps average dispatch jitter.
    reps, trial_rates = 3, []
    for trial in range(4):
        if trial:
            time.sleep(5.0)
        t0 = time.perf_counter()
        for _ in range(reps):
            np.asarray(run(windows)[-1])
        trial_rates.append(n_bench / ((time.perf_counter() - t0) / reps))
    device_rate = max(trial_rates)
    median_rate = sorted(trial_rates)[len(trial_rates) // 2]

    # --- baseline: reference-style per-row loop, median of 3 runs ---
    n_base = 8_192
    base_sec = sorted(numpy_rowwise_fd(rows[:n_base], ell) for _ in range(3))[1]
    base_rate = n_base / base_sec

    print(json.dumps({
        "metric": "swfd_sketch_updates_per_sec",
        "value": round(device_rate, 1),
        "unit": "rows/s (d=1024, ell=64, window=2048)",
        "vs_baseline": round(device_rate / base_rate, 2),
        # value = best of 4 spaced trials; median_trial is the same
        # trials' midpoint
        "methodology": "best_of_4_spaced_trials",
        "median_trial": round(median_rate, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
