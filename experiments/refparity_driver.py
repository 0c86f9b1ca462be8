"""Mid-scale head-to-head: the ACTUAL reference vs mused_tpu (VERDICT r3 #2).

Runs the reference pipeline (via experiments/refharness.py faithful stubs)
and ours on IDENTICAL modality arrays at the reference's own CPU-feasible
regime — ``small_subset_sizes`` 8000..16000 (/root/reference/main.py:262)
with window 500-1000 (main.py:267), noise {0.5, 0.95} x sorted {False,
True} x all 6 default approaches (main.py:290-301).  Emits one JSON line
per (config, approach, side) to experiments/refparity/results.jsonl
(append-mode, resumable: done keys are skipped) — refparity_report.py
renders REFPARITY.md from it.

Both sides consume our prepare_modalities output (bit-exact RNG parity
with the reference's is certified by test_reference_parity.py), so every
metric difference is pipeline behavior, not data.  The reference side
additionally records f1_aligned/nmi via a compute_all_metrics wrapper that
captures the matched labels and scores them with our utils.metrics — the
permutation-robust comparison the raw id-dependent F1 cannot give.

Usage:
  python experiments/refparity_driver.py             # full grid, CPU
  python experiments/refparity_driver.py --configs 8000x500 --noise 0.5
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

APPROACHES = ["SVDMC_batch", "SWFDMC", "sSVDMC", "sSVDMC_hung",
              "sSVDMC_pot", "sSVDMC_mini"]
CONFIGS = [(8000, 500), (16000, 1000)]
NOISES = [0.5, 0.95]
SORTS = [False, True]
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "refparity", "results.jsonl")


def stream_key(subset, window, noise, sorting, approach, side):
    return f"s{subset}_w{window}_n{noise}_sort{int(sorting)}_{approach}_{side}"


def load_done(path):
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["key"])
                except Exception:
                    pass
    return done


def run_reference_side(ref_main, ref_metrics, mods, mtypes, labels, *,
                       approach, window, noise, sorting, subset):
    """Run one reference point, capturing matched labels for aligned scoring."""
    from mused_tpu.utils import metrics as our_metrics
    captured = {}
    orig = ref_metrics.compute_all_metrics

    def wrapper(results, subset_size, noise_rate, label_mode, sorting_,
                reduced_dim, k_basis, window_size, clusters, true_labels,
                end_time, start_time):
        captured["clusters"] = np.asarray(clusters)
        captured["true"] = np.asarray(true_labels)
        return orig(results, subset_size, noise_rate, label_mode, sorting_,
                    reduced_dim, k_basis, window_size, clusters, true_labels,
                    end_time, start_time)

    ref_metrics.compute_all_metrics = wrapper
    try:
        results, _ = ref_metrics.get_initial_results()
        kw = dict(results=results, data_modalities=mods,
                  modality_types=mtypes, reduced_dim=50, k_basis=50,
                  seed=0, approach=approach, complete_true_labels=labels,
                  noise_rate=noise, label_mode="binary", sorting=sorting,
                  eps=1.5, min_samples=2, window_size=window)
        if approach.endswith("_batch"):
            results = ref_main.process_batch_data(
                n_clusters=2, min_cluster_size=3, **kw)
        else:
            results = ref_main.process_streaming_data(
                n_clusters_total=2, step_window_ratio=1, **kw)
    finally:
        ref_metrics.compute_all_metrics = orig
    rec = {k: results[k][0] for k in ("f1_score", "nmi_score", "nmi_e_score",
                                      "precision", "recall", "accuracy",
                                      "mae", "processing_time")}
    if "clusters" in captured:
        rec["f1_aligned"] = float(our_metrics.aligned_f1(
            captured["true"], captured["clusters"]))
    return rec


def run_our_side(mods, mtypes, labels, *, approach, window, noise, sorting,
                 subset):
    from mused_tpu import api
    results, _ = api.get_initial_results()
    kw = dict(results=results, data_modalities=mods, modality_types=mtypes,
              reduced_dim=50, k_basis=50, seed=0, approach=approach,
              complete_true_labels=labels, noise_rate=noise,
              label_mode="binary", sorting=sorting, eps=1.5, min_samples=2,
              window_size=window)
    if approach.endswith("_batch"):
        results = api.process_batch_data(n_clusters=2, min_cluster_size=3,
                                         **kw)
    else:
        results = api.process_streaming_data(n_clusters_total=2,
                                             step_window_ratio=1, **kw)
    keys = ("f1_score", "nmi_score", "nmi_e_score", "precision", "recall",
            "accuracy", "mae", "processing_time", "f1_aligned")
    return {k: results[k][0] for k in keys if k in results and results[k]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="*", default=None,
                    help="subset x window, e.g. 8000x500")
    ap.add_argument("--noise", nargs="*", type=float, default=None)
    ap.add_argument("--sorted", nargs="*", type=int, default=None)
    ap.add_argument("--approaches", nargs="*", default=None)
    ap.add_argument("--sides", nargs="*", default=["ref", "ours"])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", action="store_true",
                    help="leave jax on its default backend (ours on the "
                         "accelerator) instead of the CPU")
    args = ap.parse_args()

    if not args.device:
        import jax
        jax.config.update("jax_platforms", "cpu")

    configs = CONFIGS
    if args.configs:
        configs = [tuple(int(x) for x in c.split("x")) for c in args.configs]
    noises = args.noise or NOISES
    sorts = [bool(s) for s in args.sorted] if args.sorted is not None else SORTS
    approaches = args.approaches or APPROACHES

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    done = load_done(args.out)

    from refharness import load_reference
    ref_main, ref_metrics = load_reference()
    from mused_tpu.data.synthetic import synthetic_events_dataframe
    from mused_tpu.data.sed2012 import prepare_modalities

    for subset, window in configs:
        # pool sizing convention matches mused_tpu.main --dataset synthetic:
        # 2x subset, half-noise split covers every sweep noise rate
        df = synthetic_events_dataframe(n_rows=2 * subset, n_events=6,
                                        noise_rate=0.5, seed=0)
        for noise in noises:
            for sorting in sorts:
                mods, mtypes, labels = prepare_modalities(
                    df, subset_size=subset, binary=True,
                    sort_by_uploaded=sorting, noise_rate=noise, seed=0)
                measured = float(np.mean(np.asarray(labels) == 0))
                for approach in approaches:
                    for side in args.sides:
                        key = stream_key(subset, window, noise, sorting,
                                         approach, side)
                        if key in done:
                            continue
                        t0 = time.time()
                        runner = (run_reference_side if side == "ref"
                                  else run_our_side)
                        extra = ((ref_main, ref_metrics)
                                 if side == "ref" else ())
                        try:
                            rec = runner(*extra, mods, mtypes, labels,
                                         approach=approach, window=window,
                                         noise=measured, sorting=sorting,
                                         subset=subset)
                            rec.update(ok=True)
                        except Exception as e:   # record, keep sweeping
                            rec = {"ok": False, "error": repr(e)[:300]}
                        rec.update(key=key, side=side, approach=approach,
                                   subset=subset, window=window,
                                   noise=noise, measured_noise=measured,
                                   sorting=sorting,
                                   wall_s=round(time.time() - t0, 2))
                        with open(args.out, "a") as f:
                            f.write(json.dumps(rec) + "\n")
                        print(f"[refparity] {key}: "
                              f"{rec.get('nmi_score', rec.get('error'))} "
                              f"({rec['wall_s']}s)", flush=True)


if __name__ == "__main__":
    main()
