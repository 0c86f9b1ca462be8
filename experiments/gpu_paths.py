"""Time the engine's per-platform path choices on one GPU.

    python experiments/gpu_paths.py [--out chiprun_out/gpu_paths.json]

For each choice that utils.runtime.PLATFORM_PATHS makes, both settings at
the shape where it matters:

  * scanned dispatch width W in {1, 4, 8}: the flagship stream (150,000
    rows, window 2000, k_basis 50, reduced_dim 50) end to end, SWFDMC and
    sSVDMC;
  * the affinity's share of one flagship window step: the five kNN graphs
    + OR fusion alone, against the whole device step (fusion + FD/SVD +
    KMeans), both on pre-featurized device-resident windows;
  * huge-window selection: one (2048, 98304) fused row block, strip
    (approx_max_k over the full strip) against stride-binned candidates;
  * huge-window FD fold: one 98,304-row window's blocked sketch with the
    strip + dense fold, binned + dense fold, and binned + candidate fold;
  * serving W in {1, 4, 8}: serving.StreamDetector over 30 flagship windows
    pushed in uneven chunks, in turns;
  * short offline streams (9 and 12 windows) at W in {1, 4, 8}, in turns:
    the tail group is padded to W, so a wide W pays padded window steps;
  * device trace (``trace``): jax.profiler traces of the five kNN graphs +
    fusion alone and of the whole window step over 12 pre-featurized
    windows, and of one whole flagship stream at the default W; device
    busy time is the union of the kernels' intervals on the GPU streams.

Every other time is wall clock around work that ends in block_until_ready,
after one untimed warm-up call per shape.  Prints one line per measurement
and writes them all as JSON.
"""
from __future__ import annotations

import argparse
import collections
import functools
import glob
import gzip
import json
import os
import statistics
import sys
import tempfile
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

OUT: dict = {}


def record(key: str, value) -> None:
    OUT[key] = value
    print(f"{key} = {value}", flush=True)


def best_of(fn, reps: int = 3) -> float:
    fn()                                          # compile / warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def flagship_dispatch(data):
    import chip_smoke
    mods, mtypes, labels = data
    n_windows = len(labels) // chip_smoke.WINDOW
    for approach in ("SWFDMC", "sSVDMC"):
        for w in (1, 4, 8):
            from mused_tpu.utils.config import PipelineConfig
            cfg = PipelineConfig(window_size=chip_smoke.WINDOW,
                                 reduced_dim=chip_smoke.REDUCED_DIM,
                                 k_basis=chip_smoke.K_BASIS,
                                 approach=approach, label_mode="binary",
                                 n_clusters_override=2, windows_per_batch=w)
            wall = best_of(lambda: chip_smoke.run_stream(
                mods, mtypes, labels, approach, chip_smoke.WINDOW, cfg=cfg),
                reps=2)
            record(f"flagship_{approach}_W{w}_windows_per_s",
                   round(n_windows / wall, 3))


def affinity_share(data, n: int = 12):
    """Fusion-only vs whole-step device time over n pre-featurized
    windows."""
    import chip_smoke
    from mused_tpu.engine import streaming as eng_mod
    from mused_tpu.utils.config import PipelineConfig
    mods, mtypes, labels = data
    win = chip_smoke.WINDOW
    for approach in ("SWFDMC", "sSVDMC"):
        cfg = PipelineConfig(window_size=win,
                             reduced_dim=chip_smoke.REDUCED_DIM,
                             k_basis=chip_smoke.K_BASIS, approach=approach,
                             label_mode="binary", n_clusters_override=2,
                             windows_per_batch=1)
        eng = eng_mod.StreamingEngine(cfg)
        feats = [eng.featurize([m[w * win:(w + 1) * win] for m in mods],
                               mtypes) for w in range(n)]
        dev_feats = [type(f)(*[jnp.asarray(x) for x in f]) for f in feats]
        jax.block_until_ready(dev_feats)

        def fuse_all():
            jax.block_until_ready([eng.fuse_from_features(f, mtypes)
                                   for f in dev_feats])

        def step_all():
            out = [eng.dispatch_window(None, mtypes,
                                       labels[w * win:(w + 1) * win], w,
                                       None, features=dev_feats[w]).labels
                   for w in range(n)]
            jax.block_until_ready(out)

        t_fuse, t_step = best_of(fuse_all), best_of(step_all)
        t_fuse = min(t_fuse, best_of(fuse_all))   # both orders
        record(f"step_{approach}_ms_per_window", round(1e3 * t_step / n, 3))
        record(f"affinity_{approach}_ms_per_window",
               round(1e3 * t_fuse / n, 3))
        record(f"affinity_{approach}_share_of_step", round(t_fuse / t_step, 4))


def huge_window(data, window: int = 98_304):
    import chip_smoke
    from mused_tpu.data import features as feat
    from mused_tpu.ops import binned_select as bsel
    from mused_tpu.ops import blocked_affinity as ba
    from mused_tpu.utils.config import FeatureConfig
    mods = [m[:window] for m in data[0]]
    fc = FeatureConfig()
    cols = ba.standard_columns(feat.featurize_window(*mods, fc), fc)
    k = chip_smoke.K_BASIS
    nbins = bsel.default_nbins(cols.n, k_max=3 * k)
    record("huge_nbins", nbins)
    block = min(2048, cols.n)
    start = jnp.int32(cols.n // block // 2 * block)

    def one_block(tensors, valids, idf, start, *, select, nb):
        c = ba.Columns(kinds=cols.kinds, tensors=tensors, valids=valids,
                       idf=idf)
        return ba.fused_rowblock(c, start, block, k, approx=True,
                                 select=select, nbins=nb,
                                 out_dtype=jnp.bfloat16)

    for select, nb in (("strip", 0), ("binned", nbins)):
        f = jax.jit(functools.partial(one_block, select=select, nb=nb))
        t = best_of(lambda: jax.block_until_ready(
            f(cols.tensors, cols.valids, cols.idf, start)))
        record(f"huge_block_{select}_ms", round(1e3 * t, 3))
    for name, select, nb, cand in (("strip_dense", "strip", 0, False),
                                   ("binned_dense", "binned", nbins, False),
                                   ("binned_cand", "binned", nbins, True)):
        t = best_of(lambda: jax.block_until_ready(ba.blocked_fd_sketch(
            cols, ell=chip_smoke.REDUCED_DIM, block=block, k_basis=k,
            approx_knn=True, select=select, nbins=nb, cand_fold=cand)),
            reps=2)
        record(f"huge_fold_{name}_s", round(t, 3))


def alternate(data, window: int = 98_304):
    """The two close calls again, in turns (A, B, B, A, A, B): flagship
    SWFDMC at W=4 against W=8, and the huge-window binned fold dense
    against candidate-form."""
    import chip_smoke
    from mused_tpu.data import features as feat
    from mused_tpu.ops import binned_select as bsel
    from mused_tpu.ops import blocked_affinity as ba
    from mused_tpu.utils.config import FeatureConfig, PipelineConfig
    mods, mtypes, labels = data
    n_windows = len(labels) // chip_smoke.WINDOW

    def stream(w):
        cfg = PipelineConfig(window_size=chip_smoke.WINDOW,
                             reduced_dim=chip_smoke.REDUCED_DIM,
                             k_basis=chip_smoke.K_BASIS, approach="SWFDMC",
                             label_mode="binary", n_clusters_override=2,
                             windows_per_batch=w)
        return n_windows / chip_smoke.run_stream(
            mods, mtypes, labels, "SWFDMC", chip_smoke.WINDOW, cfg=cfg)[1]

    fc = FeatureConfig()
    cols = ba.standard_columns(
        feat.featurize_window(*[m[:window] for m in mods], fc), fc)
    nbins = bsel.default_nbins(cols.n, k_max=3 * chip_smoke.K_BASIS)
    block = min(2048, cols.n)

    def fold(cand):
        t0 = time.perf_counter()
        jax.block_until_ready(ba.blocked_fd_sketch(
            cols, ell=chip_smoke.REDUCED_DIM, block=block,
            k_basis=chip_smoke.K_BASIS, approx_knn=True, select="binned",
            nbins=nbins, cand_fold=cand))
        return time.perf_counter() - t0

    for a, b, fn, key in ((4, 8, stream, "flagship_SWFDMC_windows_per_s_W"),
                          (False, True, fold, "huge_fold_binned_s_cand")):
        fn(a), fn(b)                                  # warm both
        for i, arg in enumerate((a, b, b, a, a, b)):
            record(f"{key}{arg}_run{i}", round(fn(arg), 4))


def serving_w(data, n_windows: int = 30):
    """windows/s of serving.StreamDetector at W = 1, 4, 8, in turns."""
    import chip_smoke
    from mused_tpu.serving import StreamDetector
    from mused_tpu.utils.config import PipelineConfig
    mods, mtypes, _ = data
    win = chip_smoke.WINDOW
    total = win * n_windows
    chunks = (317, 1500, 4000, 29, 2222, 999)

    def run(w):
        cfg = PipelineConfig(window_size=win,
                             reduced_dim=chip_smoke.REDUCED_DIM,
                             k_basis=chip_smoke.K_BASIS, approach="SWFDMC",
                             label_mode="all", n_clusters_override=150,
                             k_estimate="eigengap", windows_per_batch=w)
        det = StreamDetector(mtypes, win, cfg=cfg)
        out, lo, i = [], 0, 0
        t0 = time.perf_counter()
        while lo < total:
            hi = min(lo + chunks[i % len(chunks)], total)
            out.extend(det.push([m[lo:hi] for m in mods]))
            lo, i = hi, i + 1
        out.extend(det.flush())
        wall = time.perf_counter() - t0
        assert len(out) == n_windows, len(out)
        return n_windows / wall

    order = (1, 4, 8, 8, 4, 1, 1, 4, 8)
    for w in (1, 4, 8):
        run(w)                                        # compile / warm
    rates = collections.defaultdict(list)
    for w in order:
        rates[w].append(run(w))
    for w, r in sorted(rates.items()):
        record(f"serving_W{w}_windows_per_s", [round(x, 3) for x in r])
        record(f"serving_W{w}_median", round(statistics.median(r), 3))


def short_streams(data):
    """Offline SWFDMC streams of 9 and 12 windows at W = 1, 4, 8, in turns:
    the padded tail group's cost against the saved dispatches."""
    import chip_smoke
    from mused_tpu.utils.config import PipelineConfig
    mods, mtypes, labels = data
    win = chip_smoke.WINDOW
    for n_windows in (9, 12):
        sl = [m[:n_windows * win] for m in mods]
        lab = labels[:n_windows * win]

        def run(w):
            cfg = PipelineConfig(window_size=win,
                                 reduced_dim=chip_smoke.REDUCED_DIM,
                                 k_basis=chip_smoke.K_BASIS,
                                 approach="SWFDMC", label_mode="binary",
                                 n_clusters_override=2, windows_per_batch=w)
            return n_windows / chip_smoke.run_stream(
                sl, mtypes, lab, "SWFDMC", win, cfg=cfg)[1]

        for w in (1, 4, 8):
            run(w)                                    # compile / warm
        rates = collections.defaultdict(list)
        for w in (1, 4, 8, 8, 4, 1, 1, 4, 8, 8, 4, 1):
            rates[w].append(run(w))
        for w, r in sorted(rates.items()):
            record(f"short{n_windows}_W{w}_median_windows_per_s",
                   round(statistics.median(r), 3))


def device_busy(trace_dir: str) -> dict:
    """Device time in the newest perfetto trace under ``trace_dir``: the
    union of kernel intervals on the GPU's stream lines, their sum, and the
    kernels that took the most time."""
    path = max(glob.glob(os.path.join(trace_dir, "**",
                                      "perfetto_trace.json.gz"),
                         recursive=True), key=os.path.getmtime)
    with gzip.open(path) as f:
        events = json.load(f)["traceEvents"]
    procs = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    threads = {(e["pid"], e["tid"]): e["args"]["name"] for e in events
               if e.get("ph") == "M" and e.get("name") == "thread_name"}
    dev = {p for p, name in procs.items() if name.startswith("/device:")}
    lines = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("pid") in dev:
            lines[threads.get((e["pid"], e["tid"]), "?")].append(e)
    kernel_lines = [n for n in lines if "Stream" in n] or [
        n for n in lines if "Module" not in n]
    spans = sorted((e["ts"], e["ts"] + e["dur"])
                   for n in kernel_lines for e in lines[n])
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    per_kernel = collections.Counter()
    for n in kernel_lines:
        for e in lines[n]:
            per_kernel[e["name"]] += e["dur"]
    return {"busy_us": round(busy, 1),
            "kernel_sum_us": round(sum(hi - lo for lo, hi in spans), 1),
            "n_kernels": len(spans),
            "lines": {n: [len(v), round(sum(e["dur"] for e in v), 1)]
                      for n, v in lines.items()},
            "kernel_lines": kernel_lines,
            "top_kernels": [[k, round(v, 1)]
                            for k, v in per_kernel.most_common(12)]}


def traced(fn) -> tuple[float, dict]:
    """(wall seconds, device_busy) of one traced call of ``fn``."""
    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d, create_perfetto_trace=True,
                                profiler_options=opts):
            t0 = time.perf_counter()
            fn()
            wall = time.perf_counter() - t0
        return wall, device_busy(d)


def trace(data, n: int = 12):
    """Device-time share of the affinity in the flagship window step, and
    the device's idle share over one whole flagship stream."""
    import chip_smoke
    from mused_tpu.engine import streaming as eng_mod
    from mused_tpu.utils.config import PipelineConfig
    mods, mtypes, labels = data
    win = chip_smoke.WINDOW
    for approach in ("SWFDMC", "sSVDMC"):
        cfg = PipelineConfig(window_size=win,
                             reduced_dim=chip_smoke.REDUCED_DIM,
                             k_basis=chip_smoke.K_BASIS, approach=approach,
                             label_mode="binary", n_clusters_override=2,
                             windows_per_batch=1)
        eng = eng_mod.StreamingEngine(cfg)
        feats = [eng.featurize([m[w * win:(w + 1) * win] for m in mods],
                               mtypes) for w in range(n)]
        dev_feats = [type(f)(*[jnp.asarray(x) for x in f]) for f in feats]
        jax.block_until_ready(dev_feats)

        def fuse_all():
            jax.block_until_ready([eng.fuse_from_features(f, mtypes)
                                   for f in dev_feats])

        def step_all():
            jax.block_until_ready([eng.dispatch_window(
                None, mtypes, labels[w * win:(w + 1) * win], w, None,
                features=dev_feats[w]).labels for w in range(n)])

        fuse_all(), step_all()                        # compile / warm
        (wf, bf), (ws, bs) = traced(fuse_all), traced(step_all)
        record(f"trace_{approach}_affinity_device_ms_per_window",
               round(bf["busy_us"] / 1e3 / n, 3))
        record(f"trace_{approach}_step_device_ms_per_window",
               round(bs["busy_us"] / 1e3 / n, 3))
        record(f"trace_{approach}_affinity_device_share",
               round(bf["busy_us"] / bs["busy_us"], 4))
        record(f"trace_{approach}_step_wall_ms_per_window",
               round(1e3 * ws / n, 3))
        record(f"trace_{approach}_fuse_detail", bf)
        record(f"trace_{approach}_step_detail", bs)
        n_windows = len(labels) // win
        run = functools.partial(chip_smoke.run_stream, mods, mtypes, labels,
                                approach, win)
        run()                                         # warm, default W
        wall, b = traced(run)
        record(f"trace_{approach}_stream_windows_per_s",
               round(n_windows / wall, 3))
        record(f"trace_{approach}_stream_device_busy_share",
               round(b["busy_us"] / 1e6 / wall, 4))
        record(f"trace_{approach}_stream_detail", b)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/gpu_paths.json")
    ap.add_argument("--phases", nargs="+",
                    default=["affinity_share", "huge_window",
                             "flagship_dispatch"],
                    choices=["affinity_share", "huge_window",
                             "flagship_dispatch", "alternate", "serving_w",
                             "short_streams", "trace"])
    args = ap.parse_args()
    import chip_smoke
    gpu = chip_smoke.require_gpu()
    from mused_tpu.utils.runtime import enable_compilation_cache
    enable_compilation_cache()
    record("card", chip_smoke.card_lines())
    record("device_kind", gpu.device_kind)
    data = chip_smoke.flagship_data()
    for fn in (globals()[name] for name in args.phases):
        t0 = time.perf_counter()
        fn(data)
        print(f"# {fn.__name__}: {time.perf_counter() - t0:.1f}s", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(OUT, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
