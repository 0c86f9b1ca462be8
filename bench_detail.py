"""Full BASELINE.md benchmark table -> BENCH_DETAIL.{md,json}.

bench.py stays the driver's ONE-json-line headline (config #1); this script
records all five BASELINE.md configs so regressions anywhere in the system
are visible (VERDICT r1 next #4):

  #1 sketch updates/sec (same workload as bench.py)
  #2 crisis text+image embedding stream, ell=128 + spectral: windows/s, F1/NMI
  #3 huge-window regime: 100k-row windows over the blocked rematerialized
     path: sketch rows/sec/chip (reduction-only) + 3b: the ~1M-row stream
     through the REAL engine, e2e rows/s + F1/NMI (BASELINE #3 as written)
  #4 d=4096 affinity: the XLA sim + top_k + scatter path, GFLOP/s
  #5 8-virtual-device CPU mesh: merged-sketch (data_shards=8) F1/NMI delta
     vs single-chip (run in a subprocess so the host platform can be forced)
  #6 serving surface: StreamDetector sustained rows/s vs the offline engine
     on the same crisis stream, push p50/p99, label lag, save/load cost, and
     the label-free (eigengap + centroid) quality record
  #7 ingest: native C++ SED2012 scanner vs O(1)-memory iterparse on a
     150k-record corpus-shaped XML (host tier — the one pipeline stage that
     had no committed number, VERDICT r4 missing #4)

Timing uses in-graph repetition + scalar materialization where per-call
dispatch overhead would otherwise dominate.  Needs a GPU: with no
accelerator it exits non-zero instead of timing the CPU.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

RESULTS: dict = {}


def _materialize(x):
    return np.asarray(x)


def config1_sketch():
    import jax, jax.numpy as jnp
    from mused_tpu.ops import fd, swfd
    d, ell, window = 1024, 64, 2048
    n_windows = 32
    n = window * n_windows
    rng = np.random.default_rng(0)
    rows = (rng.random((n, d)) < 0.05).astype(np.float32)
    windows = jnp.asarray(rows.reshape(n_windows, window, d))

    mode = fd.resolve_fold_mode("subspace")   # engine window-summary mode

    @jax.jit
    def run(ws):
        def step(state, w):
            st = fd.update_stream(fd.init(ell, d), w, mode=mode)
            state = swfd.absorb_summary(state, st.sketch, jnp.int32(window),
                                        st.sq_frobenius, st.shrink_loss)
            sketch, _, _, _ = swfd.query(state, window=window, sketch_dim=ell)
            return state, sketch
        state = swfd.init(window, d, ell, block_rows=window)
        _, sketches = jax.lax.scan(step, state, ws)
        return sketches
    _materialize(run(windows)[-1])
    reps, rates = 3, []
    for _ in range(3):              # spaced trials
        t0 = time.perf_counter()
        for _ in range(reps):
            _materialize(run(windows)[-1])
        rates.append(n / ((time.perf_counter() - t0) / reps))
    rates.sort()
    RESULTS["1_sketch_rows_per_sec"] = round(rates[-1], 1)
    # error bar: per-key spread across the trials the best-of comes from
    RESULTS["1_sketch_trial_spread_pct"] = round(
        100.0 * (rates[-1] - rates[0]) / rates[len(rates) // 2], 1)


def config1b_e2e_stream():
    """Flagship e2e stream (the STATUS headline): SWFDMC, window=2000,
    k_basis=50, 5 standard modalities — per-window dispatch vs the scanned
    multi-window dispatch (windows_per_batch=8, numerically identical)."""
    import time as _t
    from mused_tpu import api
    from mused_tpu.data.synthetic import synthetic_events_dataframe
    from mused_tpu.data.sed2012 import prepare_modalities
    from mused_tpu.utils.config import PipelineConfig
    window, n_windows = 2000, 24
    subset = window * n_windows
    df = synthetic_events_dataframe(n_rows=subset + 512, n_events=6,
                                    noise_rate=0.9, seed=0)
    mods, mtypes, labels = prepare_modalities(
        df, subset_size=subset, binary=True, sort_by_uploaded=True,
        noise_rate=0.9, seed=0)

    def run(batch_w):
        cfg = PipelineConfig(window_size=window, reduced_dim=50, k_basis=50,
                             approach="SWFDMC", label_mode="binary",
                             n_clusters_override=2, windows_per_batch=batch_w)
        r, _ = api.get_initial_results()
        t0 = _t.perf_counter()
        api.process_streaming_data(
            results=r, data_modalities=mods, modality_types=mtypes,
            window_size=window, reduced_dim=50, k_basis=50,
            n_clusters_total=2, seed=0, approach="SWFDMC",
            complete_true_labels=labels, step_window_ratio=1, noise_rate=0.9,
            label_mode="binary", sorting=True, eps=1.5, min_samples=2,
            cfg=cfg)
        return n_windows / (_t.perf_counter() - t0)

    for batch_w, key in ((1, "1b_e2e_windows_per_sec_perwindow"),
                         (4, "1b_e2e_windows_per_sec_scanned4"),
                         (8, "1b_e2e_windows_per_sec_scanned8"),
                         # what a flag-less user gets: auto scanned dispatch
                         # (engine.resolve_windows_per_batch — W=8 here since
                         # the 24-window stream length is known offline)
                         (None, "1b_e2e_windows_per_sec_default_auto")):
        run(batch_w)                         # compile/warm
        trials = sorted(run(batch_w) for _ in range(2))
        RESULTS[key] = round(trials[-1], 1)
        if key == "1b_e2e_windows_per_sec_default_auto":
            RESULTS["1b_e2e_trial_spread_pct"] = round(
                100.0 * (trials[-1] - trials[0]) / trials[-1], 1)


def config2_crisis_spectral():
    from mused_tpu import api
    from mused_tpu.data.synthetic import crisis_embedding_stream
    from mused_tpu.utils.config import PipelineConfig
    window, subset = 512, 4096
    mods, mtypes, labels = crisis_embedding_stream(
        n_rows=subset, n_events=5, noise_rate=0.3, d_text=256, d_image=256,
        seed=0)

    def run(match, batch_w=1):
        cfg = PipelineConfig(window_size=window, reduced_dim=128, k_basis=8,
                             approach="sSpectral", label_mode="all",
                             n_clusters_override=6, eps=1.5, min_samples=2,
                             matching=match, windows_per_batch=batch_w)
        r, _ = api.get_initial_results()
        t0 = time.perf_counter()
        r = api.process_streaming_data(
            results=r, data_modalities=mods, modality_types=mtypes,
            window_size=window, reduced_dim=128, k_basis=8,
            n_clusters_total=6, seed=0, approach="sSpectral",
            complete_true_labels=labels, step_window_ratio=1, noise_rate=0.3,
            label_mode="all", sorting=False, eps=1.5, min_samples=2, cfg=cfg)
        return (subset // window) / (time.perf_counter() - t0), r

    # headline: centroid cross-window matching (ops/matching.CentroidMatcher)
    # — the stream is temporally unsorted, so the reference's positional-
    # overlap matching cannot stabilize IDs across windows (recorded below
    # for transparency) even though per-window clustering is good
    run("centroid")                         # compile/warm
    wps, r = run("centroid")
    wps = max(wps, run("centroid")[0])      # best-of-2
    RESULTS["2_crisis_windows_per_sec"] = round(wps, 2)
    RESULTS["2_crisis_f1"] = round(r["f1_score"][0], 4)
    # the raw F1 treats cluster ids as class labels (reference semantics),
    # so the registry's label-free id numbering caps it even at a perfect
    # partition; the aligned F1 scores the partition itself
    # (utils/metrics.aligned_f1, VERDICT r2 weak #3)
    RESULTS["2_crisis_f1_aligned"] = round(r["f1_aligned"][0], 4)
    RESULTS["2_crisis_nmi"] = round(r["nmi_score"][0], 4)
    RESULTS["2_crisis_nmi_e"] = round(r["nmi_e_score"][0], 4)
    run("centroid", batch_w=4)              # scanned dispatch (identical NMI)
    wps4 = max(run("centroid", batch_w=4)[0], run("centroid", batch_w=4)[0])
    RESULTS["2_crisis_windows_per_sec_scanned4"] = round(wps4, 2)
    _, r_pos = run("auto")
    RESULTS["2_crisis_nmi_positional_matching"] = round(r_pos["nmi_score"][0], 4)


def config3_huge_window():
    import jax
    from mused_tpu.data.synthetic import synthetic_events_dataframe
    from mused_tpu.data.sed2012 import prepare_modalities
    from mused_tpu.data import features as feat
    from mused_tpu.ops import blocked_affinity as ba
    from mused_tpu.utils.config import FeatureConfig
    window = 98_304                       # 100k-window regime, 2048 | n
    df = synthetic_events_dataframe(n_rows=window + 64, n_events=6,
                                    noise_rate=0.9, seed=0)
    mods, _, _ = prepare_modalities(df, subset_size=window, binary=True,
                                    sort_by_uploaded=False, noise_rate=0.9,
                                    seed=0)
    fc = FeatureConfig()
    wf = feat.featurize_window(*mods, fc)
    cols = ba.standard_columns(wf, fc)
    # mirror the engine defaults: approx_knn on, binned selection per the
    # platform (PipelineConfig.huge_window_fused_select=None)
    from mused_tpu.ops import binned_select as bsel
    from mused_tpu.utils.runtime import platform_paths
    nbins = (bsel.default_nbins(cols.n, k_max=150)
             if platform_paths().binned_select else 0)
    select = "binned" if nbins else "strip"
    sk, sq, loss = ba.blocked_fd_sketch(cols, ell=64, block=2048, k_basis=50,
                                        approx_knn=True, select=select,
                                        nbins=nbins)
    _materialize(sk)                      # compile + warm
    dt = float("inf")
    for _ in range(2):                    # best-of-2
        t0 = time.perf_counter()
        sk, sq, loss = ba.blocked_fd_sketch(cols, ell=64, block=2048,
                                            k_basis=50, approx_knn=True,
                                            select=select, nbins=nbins)
        _materialize(sk)
        dt = min(dt, time.perf_counter() - t0)
    # reduction-only kernel numbers (ONE window's blocked FD sketch — no
    # featurization/transfer/clustering/matching); the e2e stream number
    # for this regime is config 3b below (VERDICT r2 weak #7)
    RESULTS["3_hugewindow_reduction_rows_per_sec_per_chip"] = round(window / dt, 1)
    RESULTS["3_hugewindow_reduction_seconds_per_100k_window"] = round(dt, 2)


def config3b_stream_1m():
    """BASELINE #3 AS WRITTEN: a ~1M-row stream at ~100k windows through the
    REAL engine (SWFDMC, auto huge-window blocked path) — featurization,
    transfer, FD fold, query, clustering, matching and metrics all included.

    FIXTURE (round 4, VERDICT r3 next #1 — the huge-window accuracy
    oracle): time-localized planted events on a SORTED stream with all-ids
    labels, so per-window clustering has recoverable structure and the
    cross-window id chains are meaningful — NMI_e / f1_aligned become
    quality signals that MOVE if the candidate-fold/binned-selection
    numerics break (the previous binary/unsorted fixture scored NMI 0.0 by
    construction: 24 spatially-distinct events collapsed into one class at
    per-window k=2).  n_events=120 at noise 0.95 keeps each event ~410 rows
    — cliquish under the k_basis=50 kNN (bigger events score WORSE:
    a fixture probe measured noise 0.5's 2048-row events at NMI_e 0.48
    vs 0.78 here) — and ~12 events live per 98k window.  Committed floors:
    3b_stream1m_nmi_e >= 0.5, f1_aligned >= 0.6 (quality_floor_ok below);
    tests/test_cand_fold.py pins fold-ON == fold-OFF end metrics on the
    same fixture at test scale."""
    from mused_tpu import api
    from mused_tpu.data.synthetic import synthetic_events_dataframe
    from mused_tpu.data.sed2012 import prepare_modalities
    n_windows, window = 10, 98_304
    total = n_windows * window
    df = synthetic_events_dataframe(n_rows=2 * total, n_events=120,
                                    noise_rate=0.5, seed=0)
    mods, mtypes, labels = prepare_modalities(
        df, subset_size=total, binary=False, event_types=False,
        sort_by_uploaded=True, noise_rate=0.95, seed=0)

    def run(n_rows):
        results, _ = api.get_initial_results()
        t0 = time.perf_counter()
        results = api.process_streaming_data(
            results=results, data_modalities=[m[:n_rows] for m in mods],
            modality_types=mtypes, window_size=window, reduced_dim=50,
            k_basis=50, n_clusters_total=150, seed=0, approach="SWFDMC",
            complete_true_labels=labels[:n_rows], step_window_ratio=1,
            noise_rate=0.95, label_mode="all", sorting=True, eps=1.5,
            min_samples=2)
        return time.perf_counter() - t0, results

    run(2 * window)      # warm the blocked-path compiles (~30 s first time;
                         # every other config warms the same way)
    dt, results = run(total)
    RESULTS["3b_stream1m_rows_per_sec_e2e"] = round(total / dt, 1)
    RESULTS["3b_stream1m_seconds_per_window_e2e"] = round(dt / n_windows, 2)
    RESULTS["3b_stream1m_f1"] = round(results["f1_score"][0], 4)
    RESULTS["3b_stream1m_f1_aligned"] = round(results["f1_aligned"][0], 4)
    RESULTS["3b_stream1m_nmi"] = round(results["nmi_score"][0], 4)
    RESULTS["3b_stream1m_nmi_e"] = round(results["nmi_e_score"][0], 4)
    RESULTS["3b_quality_floor_ok"] = bool(
        results["nmi_e_score"][0] >= 0.5 and results["f1_aligned"][0] >= 0.6)


def config4_affinity_gflops():
    import jax, jax.numpy as jnp
    from mused_tpu.ops import affinity
    n, d, k, K = 2048, 4096, 50, 16
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    xj = jnp.asarray(x)
    valid = jnp.ones((n,), bool)
    flops = 2.0 * n * n * d

    def timeit(fn):
        @jax.jit
        def loop(x):
            def body(i, acc):
                return acc + jnp.sum(fn(x + acc * 1e-30))
            return jax.lax.fori_loop(0, K, body, jnp.float32(0.0))
        _materialize(loop(xj))
        best = float("inf")
        for _ in range(2):              # best-of-2
            t0 = time.perf_counter()
            for _ in range(3):
                _materialize(loop(xj))
            best = min(best, (time.perf_counter() - t0) / 3 / K)
        return best

    t_xla = timeit(lambda x: affinity.knn_adjacency(
        jnp.dot(x, x.T, preferred_element_type=jnp.float32), valid, k))
    RESULTS["4_affinity_xla_gflops"] = round(flops / t_xla / 1e9, 1)


def config6_serving():
    """Serving-surface benchmark (VERDICT r3 next #4): StreamDetector on the
    crisis stream — sustained rows/s vs the offline engine on the SAME
    stream, push-call p50/p99 latency, observed label lag, save/load cost,
    and the label-free quality record (k_estimate="eigengap" + centroid
    matching: no ground truth anywhere in the serving path; VERDICT r3
    weak #5).

    Serving and the offline loop share the platform's W; serving's label
    lag is W-1+max_lag windows (the W=8 setting is also probed explicitly
    as 6_serving_rows_per_sec_w8).  Round 5: featurize+dispatch run on the
    bounded dispatch worker, so closed-loop (saturated) push latency
    measures BACKPRESSURE, not dispatch; the production latency claim is
    the paced open-loop p99 at ~80% of measured capacity
    (6_serving_push_p99_ms_paced80)."""
    import os
    import tempfile
    from mused_tpu import api
    from mused_tpu.serving import StreamDetector
    from mused_tpu.data.synthetic import crisis_embedding_stream
    from mused_tpu.utils.config import PipelineConfig
    from mused_tpu.utils import metrics as m
    window, subset, chunk = 512, 8192, 64
    mods, mtypes, labels = crisis_embedding_stream(
        n_rows=subset, n_events=5, noise_rate=0.3, d_text=256, d_image=256,
        seed=0)
    det_kw = dict(approach="sSpectral", reduced_dim=128, k_basis=8,
                  max_events=32, k_estimate="eigengap", matching="centroid",
                  max_lag=2)

    def stream_through(det, pace_rows_per_sec=None):
        lat, results, max_lag_w = [], [], 0
        t0 = time.perf_counter()
        for i, lo in enumerate(range(0, subset, chunk)):
            if pace_rows_per_sec is not None:
                # open-loop arrivals: sleep to the chunk's scheduled time
                due = t0 + (i * chunk) / pace_rows_per_sec
                now = time.perf_counter()
                if due > now:
                    time.sleep(due - now)
            rows = [mm[lo:lo + chunk] for mm in mods]
            t1 = time.perf_counter()
            results.extend(det.push(rows))
            lat.append(time.perf_counter() - t1)
            fired = (lo + chunk) // window
            max_lag_w = max(max_lag_w, fired - len(results))
        results.extend(det.flush())
        wall = time.perf_counter() - t0
        return wall, lat, results, max_lag_w

    # offline engine on the SAME stream/config, defined up front so the
    # serving/offline RATIO comes from PAIRED back-to-back trials
    cfg = PipelineConfig(window_size=window, reduced_dim=128, k_basis=8,
                         approach="sSpectral", label_mode="all",
                         n_clusters_override=32, matching="centroid",
                         k_estimate="eigengap")

    def offline():
        r, _ = api.get_initial_results()
        t0 = time.perf_counter()
        api.process_streaming_data(
            results=r, data_modalities=mods, modality_types=mtypes,
            window_size=window, reduced_dim=128, k_basis=8,
            n_clusters_total=32, seed=0, approach="sSpectral",
            complete_true_labels=labels, step_window_ratio=1, noise_rate=0.3,
            label_mode="all", sorting=False, eps=1.5, min_samples=2, cfg=cfg)
        return subset / (time.perf_counter() - t0)

    stream_through(StreamDetector(mtypes, window, **det_kw))   # compile/warm
    offline()                                                  # compile/warm
    pairs = []
    best = (np.inf, None, None, None)
    for _ in range(3):
        wall_i, lat_i, res_i, lag_i = stream_through(
            StreamDetector(mtypes, window, **det_kw))
        off_i = offline()
        pairs.append((subset / wall_i, off_i))
        if wall_i < best[0]:
            best = (wall_i, lat_i, res_i, lag_i)
    wall, lat, results, max_lag_w = best
    lat_ms = np.array(lat) * 1e3
    RESULTS["6_serving_rows_per_sec"] = round(subset / wall, 1)
    RESULTS["6_serving_push_p50_ms"] = round(
        float(np.percentile(lat_ms, 50)), 2)
    RESULTS["6_serving_push_p99_ms"] = round(
        float(np.percentile(lat_ms, 99)), 2)
    RESULTS["6_serving_observed_label_lag_windows"] = int(max_lag_w)
    RESULTS["6_serving_offline_rows_per_sec_same_stream"] = round(
        max(o for _, o in pairs), 1)
    # structural ratio: best over PAIRED trials
    RESULTS["6_serving_vs_offline"] = round(max(s / o for s, o in pairs), 3)
    RESULTS["6_serving_trial_spread_pct"] = round(
        100.0 * (max(s for s, _ in pairs) - min(s for s, _ in pairs))
        / max(s for s, _ in pairs), 1)

    # production latency: paced open-loop arrivals at 80% of the measured
    # closed-loop capacity — the worker keeps up, so every push should be
    # copy + enqueue (VERDICT r4 next #3 target: p99 <= ~10 ms)
    _, lat80, _, _ = stream_through(
        StreamDetector(mtypes, window, **det_kw),
        pace_rows_per_sec=0.8 * subset / wall)
    lat80_ms = np.array(lat80) * 1e3
    RESULTS["6_serving_push_p99_ms_paced80"] = round(
        float(np.percentile(lat80_ms, 99)), 2)

    # W=8 opt-in (documented lag 9 = W-1+max_lag): closes the structural
    # half of the serving-vs-offline gap for lag-tolerant callers
    cfg8 = StreamDetector(mtypes, window, **det_kw).cfg.replace(
        windows_per_batch=8)
    stream_through(StreamDetector(mtypes, window, cfg=cfg8,
                                  max_lag=2))      # compile/warm
    w8_wall = min(stream_through(StreamDetector(
        mtypes, window, cfg=cfg8, max_lag=2))[0] for _ in range(2))
    RESULTS["6_serving_rows_per_sec_w8"] = round(subset / w8_wall, 1)

    # label-free quality: score the emitted windows against the (held-back)
    # truth — the detector itself never sees labels
    order = np.argsort([r.window_index for r in results])
    clus = np.concatenate([results[i].clusters for i in order])
    truth = labels[:len(clus)]
    RESULTS["6_serving_nmi"] = round(m.nmi(truth, clus), 4)
    RESULTS["6_serving_nmi_e"] = round(m.nmi_events_only(truth, clus), 4)
    RESULTS["6_serving_f1_aligned"] = round(m.aligned_f1(truth, clus), 4)

    # background bucket (round 5): same stream, background=True — the
    # label-free bucket recovers the truth's scattered-noise class
    _, _, res_bg, _ = stream_through(
        StreamDetector(mtypes, window, background=True, **det_kw))
    order = np.argsort([r.window_index for r in res_bg])
    clus_bg = np.concatenate([res_bg[i].clusters for i in order])
    RESULTS["6_serving_nmi_bg"] = round(m.nmi(truth, clus_bg), 4)
    RESULTS["6_serving_nmi_e_bg"] = round(
        m.nmi_events_only(truth, clus_bg), 4)
    RESULTS["6_serving_f1_aligned_bg"] = round(
        m.aligned_f1(truth, clus_bg), 4)
    RESULTS["6_serving_background_frac"] = round(
        float((clus_bg == -1).mean()), 4)

    # save/load cost (flushes pending windows first — measured as the user
    # sees it mid-stream)
    det = StreamDetector(mtypes, window, **det_kw)
    for lo in range(0, subset // 2, chunk):
        det.push([mm[lo:lo + chunk] for mm in mods])
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "det.npz")
        t0 = time.perf_counter()
        det.save(path)
        RESULTS["6_serving_save_ms"] = round(
            (time.perf_counter() - t0) * 1e3, 1)
        t0 = time.perf_counter()
        StreamDetector.load(path)
        RESULTS["6_serving_load_ms"] = round(
            (time.perf_counter() - t0) * 1e3, 1)


_WORDS = ("plaza fiesta goal stadium madrid protest camera street night "
          "day crowd music concert rain sun festival sample photo test").split()


def synth_corpus(path, n):
    """Write an n-record SED2012-shaped metadata XML (realistic field
    sizes) for the ingest benchmark."""
    rng = np.random.default_rng(0)
    with open(path, "w", encoding="utf-8") as f:
        f.write("<photos>\n")
        for i in range(n):
            ws = rng.integers(0, len(_WORDS), 12)
            title = " ".join(_WORDS[w] for w in ws[:4]).title()
            desc = " ".join(_WORDS[w] for w in ws) + " &amp; more!"
            tags = "".join(f"<tag>{_WORDS[w]}</tag>" for w in ws[:5])
            lat = -90 + 180 * rng.random()
            lon = -180 + 360 * rng.random()
            f.write(
                f'  <photo id="{1000000 + i}" dateTaken="2012-05-0'
                f'{1 + i % 9} 10:{i % 60:02d}:00.0" dateUploaded="2012-05-0'
                f'{1 + i % 9} 11:{i % 60:02d}:00.0" username="user{i % 997}">\n'
                f'    <location latitude="{lat:.6f}" longitude="{lon:.6f}"/>\n'
                f'    <title>{title}</title>\n'
                f'    <description>{desc}</description>\n'
                f'    <tags>{tags}</tags>\n'
                f'  </photo>\n')
        f.write("</photos>\n")


def config7_ingest():
    """Ingest tier benchmark (VERDICT r4 missing #4): the native C++
    chunk-parallel SED2012 scanner (native/sed2012_parser.cpp) vs the
    O(1)-memory Python iterparse path, both through the SAME
    parse_metadata surface on a 150k-record corpus-shaped synthetic XML
    (realistic field sizes; the real ~400MB MediaEval corpus is
    network-blocked, SURVEY.md §2 #10).  Rates are full-path rows/s
    (scan + decode + DataFrame build) — what load_sed2012_dataset sees.
    """
    import os
    from mused_tpu import native
    from mused_tpu.data import sed2012

    n = 150_000
    path = "/tmp/mused_ingest_bench150k.xml"
    if not os.path.exists(path):
        # atomic: a bench killed mid-synth must not leave a truncated
        # corpus that silently breaks every later regen
        synth_corpus(path + ".tmp", n)
        os.replace(path + ".tmp", path)
    RESULTS["7_ingest_records"] = n
    RESULTS["7_ingest_corpus_mb"] = round(os.path.getsize(path) / 1e6, 1)

    if native.parse_sed2012(path, max_records=1, clean=True) is None:
        RESULTS["7_ingest_error"] = "native parser unavailable"
        return
    best_native = 0.0
    for _ in range(3):                      # best-of: host-cache warmup
        t0 = time.perf_counter()
        df = sed2012.parse_metadata(path, {}, use_native=True)
        best_native = max(best_native, n / (time.perf_counter() - t0))
    if len(df) != n:                        # stale/foreign file: self-heal
        synth_corpus(path + ".tmp", n)
        os.replace(path + ".tmp", path)
        return config7_ingest()
    t0 = time.perf_counter()
    df_py = sed2012.parse_metadata(path, {}, use_native=False)
    py_rate = n / (time.perf_counter() - t0)
    assert len(df_py) == n, len(df_py)
    RESULTS["7_ingest_native_rows_per_sec"] = round(best_native, 1)
    RESULTS["7_ingest_iterparse_rows_per_sec"] = round(py_rate, 1)
    RESULTS["7_ingest_native_speedup"] = round(best_native / py_rate, 2)


_SHARDED_SNIPPET = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax; jax.config.update("jax_platforms", "cpu")
import json, numpy as np
from mused_tpu import api
from mused_tpu.data.synthetic import synthetic_events_dataframe
from mused_tpu.utils.config import PipelineConfig
df = synthetic_events_dataframe(n_rows=900, n_events=4, noise_rate=0.6, seed=0)
mods, mtypes, labels = api.prepare_modalities(df, subset_size=512, binary=True,
    sort_by_uploaded=True, noise_rate=0.5, seed=0)
out = {}
for shards in (1, 8):
    cfg = PipelineConfig(window_size=128, reduced_dim=16, k_basis=4,
                         approach="SWFDMC", label_mode="binary",
                         n_clusters_override=2, data_shards=shards,
                         eps=1.5, min_samples=2)
    r, _ = api.get_initial_results()
    r = api.process_streaming_data(results=r, data_modalities=mods,
        modality_types=mtypes, window_size=128, reduced_dim=16, k_basis=4,
        n_clusters_total=2, seed=0, approach="SWFDMC",
        complete_true_labels=labels, step_window_ratio=1, noise_rate=0.5,
        label_mode="binary", sorting=True, eps=1.5, min_samples=2, cfg=cfg)
    out[str(shards)] = {"f1": r["f1_score"][0], "nmi": r["nmi_score"][0]}
# columns-layout huge-window sweep (features column-sharded over the mesh,
# parallel/colsharded) vs the single-chip blocked sketch
for tag, shards, layout in (("blk1", 1, "rows"), ("cols8", 8, "columns")):
    cfg = PipelineConfig(window_size=128, reduced_dim=16, k_basis=4,
                         approach="SWFDMC", label_mode="binary",
                         n_clusters_override=2, data_shards=shards,
                         force_blocked_window=True,
                         huge_window_layout=layout if shards > 1 else "rows",
                         eps=1.5, min_samples=2)
    r, _ = api.get_initial_results()
    r = api.process_streaming_data(results=r, data_modalities=mods,
        modality_types=mtypes, window_size=128, reduced_dim=16, k_basis=4,
        n_clusters_total=2, seed=0, approach="SWFDMC",
        complete_true_labels=labels, step_window_ratio=1, noise_rate=0.5,
        label_mode="binary", sorting=True, eps=1.5, min_samples=2, cfg=cfg)
    out[tag] = {"f1": r["f1_score"][0], "nmi": r["nmi_score"][0]}
print("RESULT " + json.dumps(out))
"""


def config5_merged_sketch_delta():
    proc = subprocess.run([sys.executable, "-c", _SHARDED_SNIPPET],
                          capture_output=True, text=True, timeout=1200)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            out = json.loads(line[len("RESULT "):])
            RESULTS["5_mesh8_f1"] = round(out["8"]["f1"], 4)
            RESULTS["5_singlechip_f1"] = round(out["1"]["f1"], 4)
            RESULTS["5_merged_sketch_f1_delta"] = round(
                out["8"]["f1"] - out["1"]["f1"], 4)
            RESULTS["5_merged_sketch_nmi_delta"] = round(
                out["8"]["nmi"] - out["1"]["nmi"], 4)
            if "cols8" in out:
                RESULTS["5b_colsharded_f1_delta"] = round(
                    out["cols8"]["f1"] - out["blk1"]["f1"], 4)
                RESULTS["5b_colsharded_nmi_delta"] = round(
                    out["cols8"]["nmi"] - out["blk1"]["nmi"], 4)
            return
    RESULTS["5_error"] = (proc.stderr or proc.stdout)[-400:]


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="+", default=None,
                    choices=["config1", "config1b", "config2", "config3",
                             "config3b", "config4", "config5", "config6",
                             "config7"],
                    help="rerun just these configs (e.g. config6), merging "
                         "into the existing BENCH_DETAIL.json")
    args = ap.parse_args()

    from mused_tpu.utils.runtime import enable_compilation_cache
    enable_compilation_cache()
    import jax
    from bench import require_gpu
    require_gpu()
    if args.only:
        try:
            with open("BENCH_DETAIL.json") as f:
                RESULTS.update(json.load(f))
        except FileNotFoundError:
            pass
    RESULTS["backend"] = jax.default_backend()

    for name, fn in [("config1", config1_sketch),
                     ("config1b", config1b_e2e_stream),
                     ("config2", config2_crisis_spectral),
                     ("config3", config3_huge_window),
                     ("config3b", config3b_stream_1m),
                     ("config4", config4_affinity_gflops),
                     ("config5", config5_merged_sketch_delta),
                     ("config6", config6_serving),
                     ("config7", config7_ingest)]:
        if args.only and name not in args.only:
            continue
        try:
            t0 = time.perf_counter()
            RESULTS.pop(f"{name}_error", None)
            fn()
            print(f"{name}: ok ({time.perf_counter() - t0:.1f}s)")
        except Exception as e:   # noqa: BLE001 — record, keep benching
            RESULTS[f"{name}_error"] = f"{type(e).__name__}: {e}"[:300]
            print(f"{name}: FAILED {type(e).__name__}")

    with open("BENCH_DETAIL.json", "w") as f:
        json.dump(RESULTS, f, indent=1, sort_keys=True)
    lines = ["# BENCH_DETAIL — all BASELINE.md configs",
             "",
             f"Backend: {RESULTS.get('backend')}   "
             f"(regenerate: `python bench_detail.py` on the GPU host)",
             "", "| key | value |", "|---|---|"]
    for k in sorted(RESULTS):
        if k != "backend":
            lines.append(f"| {k} | {RESULTS[k]} |")
    lines += [
        "",
        "## Methodology / error bars",
        "",
        "- Throughput keys are BEST of spaced trials; `*_trial_spread_pct` "
        "keys state the max-min spread of the trials each best-of came "
        "from.",
    ]
    with open("BENCH_DETAIL.md", "w") as f:
        f.write("\n".join(lines) + "\n")
    print(json.dumps(RESULTS, sort_keys=True))


if __name__ == "__main__":
    main()
