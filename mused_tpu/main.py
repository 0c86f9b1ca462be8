"""Experiment sweep driver + CLI.

Rebuilds the reference's L5 layer (main.py:169-365): ``run_experiment`` sweeps
one variable across approaches, accumulating the results schema, logging and
plotting per sweep; ``__main__`` iterates experiment types.  Upgrades over the
reference (which hard-codes everything and has no CLI, SURVEY.md §5.6):

  * argparse CLI with every reference default reproduced
    (``python -m mused_tpu.main --help``)
  * ``--dataset synthetic`` runs without the SED2012 download
  * per-experiment tee logging with proper restore
  * preserved quirks: the measured noise rate overwrites the requested one
    and mutates params across sweep values (reference main.py:196);
    eps/min_samples/min_cluster_size constants (main.py:200).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from mused_tpu.data import sed2012, synthetic
from mused_tpu.engine.batch import process_batch_data
from mused_tpu.engine.streaming import process_streaming_data
from mused_tpu.utils import metrics as metrics_mod, output, tee
from mused_tpu.utils.config import APPROACHES, PipelineConfig

EXPERIMENT_DEFAULTS = {
    # reference main.py:262-269
    "subset_size": [100000, 110000, 120000, 130000, 140000, 150000],
    "label_mode": ["binary", "types", "all"],
    "noise_rate": [0.05, 0.25, 0.50, 0.75, 0.95],
    "sorting": [False, True],
    "window_size": [500, 1000, 2000, 4000],
    "reduced_dim": [10, 20, 30, 40, 50, 60, 70, 80, 90, 100],
    "k_basis": [10, 20, 30, 40, 50, 60, 70, 80, 90, 100],
}

DEFAULT_PARAMS = {
    # reference main.py:303-313
    "seed": 0,
    "subset_size": 150000,
    "noise_rate": 0.95,
    "label_mode": "binary",
    "sorting": False,
    "window_size": 2000,
    "reduced_dim": 50,
    "k_basis": 50,
    "step_window_ratio": 1,
}


def _measured_noise_rate(df, params) -> float:
    """The ACTUAL noise share prepare_modalities delivers for ``params`` —
    the quantity the reference writes back into the sweep params
    (main.py:196).  Data-only (no engine), so a parallel driver can chain
    the mutation quirk through the sweep order cheaply (phase 1 of the
    two-phase parallel sweep)."""
    _, _, truth_labels = sed2012.prepare_modalities(
        df=df,
        subset_size=params["subset_size"],
        binary=(params["label_mode"] == "binary"),
        event_types=(params["label_mode"] != "all"),
        sort_by_uploaded=params["sorting"],
        noise_rate=params["noise_rate"],
        seed=params["seed"],
    )
    return float(np.sum(truth_labels == 0) / len(truth_labels))


def _eval_sweep_point(df, params, approach, results,
                      engine_opts: dict | None):
    """One (approach, variable value) sweep point: prepare modalities, run
    the matching engine, append one row to ``results``.  Returns the
    MEASURED noise rate so the sequential driver can apply the reference's
    params-mutation quirk (main.py:196)."""
    modalities, modality_types, truth_labels = sed2012.prepare_modalities(
        df=df,
        subset_size=params["subset_size"],
        binary=(params["label_mode"] == "binary"),
        event_types=(params["label_mode"] != "all"),
        sort_by_uploaded=params["sorting"],
        noise_rate=params["noise_rate"],
        seed=params["seed"],
    )
    measured_noise = float(np.sum(truth_labels == 0) / len(truth_labels))

    # single home of the reference constants: PipelineConfig defaults
    # (config.py mirrors reference main.py:198-200)
    _d = PipelineConfig(label_mode=params["label_mode"])
    n_clusters = _d.n_clusters_total
    eps, min_samples = _d.eps, _d.min_samples
    min_cluster_size = _d.min_cluster_size

    if approach.endswith("_batch"):
        dropped = {k: v for k, v in (engine_opts or {}).items()
                   if v not in (None, False, 1, "allgather", "rows", 0,
                                "auto", "labels", 0.15)}
        if dropped:
            print(f"[{approach}] batch engine ignores streaming engine "
                  f"options: {sorted(dropped)}")
        process_batch_data(
            results=results, data_modalities=modalities,
            modality_types=modality_types,
            reduced_dim=params["reduced_dim"],
            k_basis=params["k_basis"], n_clusters=n_clusters,
            seed=params["seed"], approach=approach,
            complete_true_labels=truth_labels,
            noise_rate=measured_noise,
            label_mode=params["label_mode"], sorting=params["sorting"],
            eps=eps, min_samples=min_samples,
            min_cluster_size=min_cluster_size,
            window_size=params["window_size"])
    else:
        process_streaming_data(
            results=results, data_modalities=modalities,
            modality_types=modality_types,
            window_size=params["window_size"],
            reduced_dim=params["reduced_dim"],
            k_basis=params["k_basis"], n_clusters_total=n_clusters,
            seed=params["seed"], approach=approach,
            complete_true_labels=truth_labels,
            step_window_ratio=params["step_window_ratio"],
            noise_rate=measured_noise,
            label_mode=params["label_mode"], sorting=params["sorting"],
            eps=eps, min_samples=min_samples, **(engine_opts or {}))
    return measured_noise


def run_experiment(df, experiment_type, variable_values, approaches,
                   fixed_params, count, log_dir="logs/", plot_dir="plots/",
                   engine_opts: dict | None = None, parallel: bool = False):
    """One sweep: variable x approaches (reference main.py:169-256).

    ``parallel=True`` evaluates the (approach, value) grid concurrently, one
    point per jax device (parallel/sweep.parallel_sweep — SURVEY.md §5.8's
    DCN/sweep-level scale-out axis), in TWO PHASES so the merged results
    equal the sequential driver's EXACTLY at any noise rate: phase 1 walks
    the sweep order sequentially but data-only, chaining the reference's
    order-dependent quirk (each point's measured noise rate overwrites the
    params for the NEXT point, main.py:196) through one cheap
    prepare_modalities call per point; phase 2 evaluates the points in
    parallel, each with its phase-1 params snapshot."""
    print(f"Running {experiment_type} experiment.")
    print(f"Fixed params: {fixed_params}")
    start_ns = time.time_ns()
    params = fixed_params.copy()
    metrics: dict = {}

    if parallel:
        from mused_tpu.parallel.sweep import parallel_sweep
        # phase 1: engine-free quirk chaining in the sequential order.
        # For a noise_rate SWEEP the chained value is dead on arrival —
        # the next iteration's `params[experiment_type] = var_value`
        # overwrites it before anything reads it — so only the LAST
        # point's measurement (the detail-string value) is computed
        points = []
        n_points = len(approaches) * len(variable_values)
        for approach in approaches:
            for var_value in variable_values:
                params[experiment_type] = var_value
                points.append((approach, var_value, params.copy()))
                if experiment_type != "noise_rate" \
                        or len(points) == n_points:
                    params["noise_rate"] = _measured_noise_rate(df, params)

        def eval_point(point):
            approach, var_value, p = point
            results_p, _ = metrics_mod.get_initial_results()
            noise = _eval_sweep_point(df, p, approach,
                                      results_p, engine_opts)
            return results_p, noise

        # phase 2: independent engine runs, one per device
        outs = parallel_sweep(eval_point, points)
        independent_variables = metrics_mod.get_initial_results()[1]
        for ai, approach in enumerate(approaches):
            merged, _ = metrics_mod.get_initial_results()
            for vi in range(len(variable_values)):
                part, _ = outs[ai * len(variable_values) + vi]
                for key, vals in part.items():
                    merged[key].extend(vals)
            metrics[approach] = merged
        # params already carries the last point's measured rate from the
        # phase-1 chain — exactly what the sequential quirk leaves behind
        # for the detail string below (phase 2 re-measures identically)
        assert abs(params["noise_rate"] - outs[-1][1]) < 1e-12
    else:
        for approach in approaches:
            results, independent_variables = metrics_mod.get_initial_results()
            approach_start = time.time_ns()

            for var_value in variable_values:
                params[experiment_type] = var_value
                print(f"Running experiment with {experiment_type} = {var_value} "
                      f"for {approach} approach")
                print(f"Params: {params}")

                # quirk preserved: measured noise rate overwrites the request
                # and persists across sweep values (reference main.py:196)
                params["noise_rate"] = _eval_sweep_point(
                    df, params, approach, results, engine_opts)

            approach_sec = (time.time_ns() - approach_start) / 1e9
            print(f"Processed with {approach} approach for {approach_sec} seconds")
            metrics[approach] = results

    details = (f'mode={params["label_mode"]},sorted={params["sorting"]},'
               f'noise={params["noise_rate"]},window={params["window_size"]},'
               f'subset={params["subset_size"]},dim={params["reduced_dim"]},'
               f'k={params["k_basis"]}')
    output.log_metrics(metrics=metrics, independent_variable=experiment_type,
                       string_to_add=details, save_path=log_dir)
    output.visualize_results(metrics=metrics, independent_variable=experiment_type,
                             independent_variables=independent_variables,
                             string_to_add=details, save_path=plot_dir)

    minutes = (time.time_ns() - start_ns) / 1e9 / 60
    print(f"Finished exp={experiment_type},{details} after {minutes} minutes")
    return count + 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mused-tpu",
        description="multimodal unsupervised streaming event detection")
    p.add_argument("--dataset", choices=["sed2012", "synthetic", "demo"],
                   default="sed2012",
                   help="sed2012 needs dataset/sed2012/ (see setup_datasets.sh); "
                        "synthetic/demo generate data")
    p.add_argument("--dataset-dir", default=sed2012.DATASET_DIR)
    p.add_argument("--max-records", type=int, default=None,
                   help="bound the SED2012 XML parse to the first N photo "
                        "records (fast end-to-end validation on the real "
                        "~400MB corpus); see also data.sed2012's "
                        "skip_records for chunked/resumable ingest")
    p.add_argument("--experiments", nargs="+",
                   default=["subset_size", "label_mode", "noise_rate", "sorting"],
                   choices=list(EXPERIMENT_DEFAULTS))
    p.add_argument("--approaches", nargs="+", default=list(APPROACHES[:6]),
                   choices=list(APPROACHES))
    for k, v in DEFAULT_PARAMS.items():
        flag = "--" + k.replace("_", "-")
        if isinstance(v, bool):
            p.add_argument(flag, type=lambda s: s.lower() in ("1", "true"),
                           default=v)
        elif isinstance(v, float):
            p.add_argument(flag, type=float, default=v)
        elif isinstance(v, str):
            p.add_argument(flag, type=str, default=v)
        else:
            p.add_argument(flag, type=int, default=v)
    p.add_argument("--second-pass-label-mode", default="types",
                   help="reference runs the full sweep twice, second pass with "
                        "this label mode (main.py:340-358); 'none' disables")
    p.add_argument("--log-dir", default="logs/")
    p.add_argument("--plot-dir", default="plots/")
    p.add_argument("--no-tee", action="store_true")
    p.add_argument("--data-shards", type=int, default=1,
                   help="run every streaming window step SPMD over this many "
                        "devices (sharded affinity + sketch merge; "
                        "window_size must be divisible by it)")
    p.add_argument("--merge-topology", choices=["allgather", "ring"],
                   default="allgather",
                   help="multi-chip FD sketch merge collective")
    p.add_argument("--huge-window-layout",
                   choices=["rows", "columns", "grid"], default="rows",
                   help="multi-chip huge-window sweep layout: rows = "
                        "replicated features, row blocks sharded "
                        "(throughput); columns = features column-sharded "
                        "over the mesh (capacity — windows whose panels "
                        "exceed one chip's HBM); grid = col-shards x "
                        "row-groups composition (SWFDMC only)")
    p.add_argument("--huge-window-col-shards", type=int, default=0,
                   help="grid layout: how many of data-shards shard the "
                        "feature columns (must divide it; 0 = balanced "
                        "auto factorization)")
    p.add_argument("--huge-window-cand-fold",
                   choices=["auto", "on", "off"], default="auto",
                   help="huge-window SWFDMC: absorb candidate-form blocks "
                        "(ops/cand_matvec).  auto = the platform's default "
                        "when every modality is binned-eligible")
    p.add_argument("--windows-per-batch", type=int, default=None,
                   help="dispatch this many tumbling windows per device call "
                        "(one lax.scan; numerically identical to per-window "
                        "dispatch).  Default: auto — the platform's W when "
                        "the approach/config is eligible, else per-window; "
                        "pass 1 to force per-window dispatch")
    p.add_argument("--matching", default="auto",
                   choices=["auto", "hungarian", "pot", "centroid"],
                   help="cross-window cluster-ID matching: auto = reference "
                        "behavior (positional overlap, pot for sSVDMC_pot "
                        "else hungarian); centroid = nearest-centroid "
                        "registry in input feature space (stable IDs on "
                        "temporally-unsorted numeric streams)")
    p.add_argument("--k-estimate", default="labels",
                   choices=["labels", "fixed", "eigengap"],
                   help="per-window cluster-count source: labels = reference "
                        "quirk (unique ground-truth labels per window, "
                        "main.py:41); fixed = n_clusters_total; eigengap = "
                        "unsupervised device estimate from the reduced "
                        "window's spectrum (no labels consulted)")
    p.add_argument("--eigengap-theta", type=float, default=0.15,
                   help="eigengap_k strong-secondary-gap veto threshold "
                        "(ADVICE r4 #3); the 0.15 default was calibrated on "
                        "planted-event windows — tune per stream family")
    p.add_argument("--background-bucket", action="store_true",
                   help="label-free background bucket: rows in the far mode "
                        "of the embedding distance-to-centroid distribution "
                        "are labeled -1 (no event) instead of being forced "
                        "into a cluster (ops/kmeans.mark_background; "
                        "sSpectral + in-graph kmeans approaches)")
    p.add_argument("--parallel-sweep", action="store_true",
                   help="evaluate the sweep's (approach, value) grid "
                        "concurrently, one point per jax device (SURVEY.md "
                        "§5.8 sweep-level scale-out). Two-phase: a cheap "
                        "sequential data-only pass first chains the "
                        "reference's noise-rate mutation quirk through the "
                        "sweep order, so parallel results == sequential "
                        "exactly, at any noise rate")
    p.add_argument("--verbose", action="store_true",
                   help="small-window debug oracles: print true labels, "
                        "fused/reduced matrices, matched clusters per window "
                        "(the reference's subset<1000 prints, main.py:35-103)")
    return p


def load_dataframe(args):
    if args.dataset == "sed2012":
        return sed2012.load_sed2012_dataset(args.dataset_dir,
                                            max_records=args.max_records)
    # pool sizing: prepare_modalities samples events and noise WITHOUT
    # replacement, so with n = 2*subset a half-noise pool covers every sweep
    # noise_rate in [0.05, 0.95] at FULL subset size (noise needed =
    # r*s <= n/2 and events (1-r)*s <= n/2 for all r in that range) — the
    # reference-default 150k-row sweeps run at their real scale (the fast
    # vectorized generator engages past 20k rows).  A subset_size SWEEP can
    # exceed the --subset-size flag, so size for its largest value too
    # (review r3 finding #2: a smaller flag would crash rng.choice mid-sweep)
    biggest = args.subset_size
    if "subset_size" in getattr(args, "experiments", []):
        biggest = max(biggest, max(EXPERIMENT_DEFAULTS["subset_size"]))
    n = max(biggest * 2, 400) if args.dataset == "synthetic" else 400
    return synthetic.synthetic_events_dataframe(
        n_rows=n, n_events=6, noise_rate=0.5, seed=args.seed)


def cli(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mused_tpu.utils.runtime import enable_compilation_cache
    enable_compilation_cache()
    start_ns = time.time_ns()
    np.random.seed(args.seed)

    if args.dataset == "demo":
        # the reference's demo smoke config (main.py:318-324)
        args.subset_size, args.window_size = 100, 8
        args.noise_rate, args.reduced_dim, args.k_basis = 0.4, 2, 1
        args.experiments = ["label_mode"]
        experiments = {"label_mode": ["binary", "types"]}
    else:
        experiments = {e: EXPERIMENT_DEFAULTS[e] for e in args.experiments}

    df = load_dataframe(args)
    default_params = {k: getattr(args, k) for k in DEFAULT_PARAMS}
    count = 0

    passes = [default_params["label_mode"]]
    if args.second_pass_label_mode not in ("none", default_params["label_mode"]) \
            and args.dataset != "demo":
        passes.append(args.second_pass_label_mode)

    for label_mode in passes:
        for experiment_type, variable_values in experiments.items():
            fixed = default_params.copy()
            fixed["label_mode"] = label_mode
            log_file = None if args.no_tee else tee.setup_logging(args.log_dir)
            try:
                count = run_experiment(df, experiment_type, variable_values,
                                       args.approaches, fixed, count,
                                       log_dir=args.log_dir,
                                       plot_dir=args.plot_dir,
                                       parallel=args.parallel_sweep,
                                       engine_opts={
                                           "data_shards": args.data_shards,
                                           "merge_topology": args.merge_topology,
                                           "huge_window_layout":
                                               args.huge_window_layout,
                                           "huge_window_col_shards":
                                               args.huge_window_col_shards,
                                           "huge_window_cand_fold":
                                               {"auto": None, "on": True,
                                                "off": False}[
                                                   args.huge_window_cand_fold],
                                           "verbose": args.verbose,
                                           "matching": args.matching,
                                           "windows_per_batch":
                                               args.windows_per_batch,
                                           "k_estimate": args.k_estimate,
                                           "eigengap_theta":
                                               args.eigengap_theta,
                                           "background_bucket":
                                               args.background_bucket,
                                       })
            finally:
                if log_file is not None:
                    tee.teardown_logging(log_file)

    minutes = (time.time_ns() - start_ns) / 1e9 / 60
    print(f"Finished running {count} experiments")
    print(f"Total processing time: {minutes} minutes")
    if count:
        print(f"Average per experiment: {minutes / count} minutes")
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
