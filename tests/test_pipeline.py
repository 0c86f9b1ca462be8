"""End-to-end pipeline tests on the synthetic SED-like fixture
(the demo-config smoke tier the reference lacked, SURVEY.md §4)."""
import numpy as np
import pytest

from mused_tpu import api
from mused_tpu.data.synthetic import synthetic_events_dataframe, load_synthetic_dataset
from mused_tpu.data.sed2012 import prepare_modalities


@pytest.fixture(scope="module")
def df():
    return synthetic_events_dataframe(n_rows=420, n_events=4, noise_rate=0.5,
                                      seed=0)


@pytest.fixture(scope="module")
def modalities(df):
    return prepare_modalities(df, subset_size=256, sort_by_uploaded=True,
                              binary=True, noise_rate=0.5, seed=0)


STREAMING_APPROACHES = ["SWFDMC", "sSVDMC", "sSVDMC_hung", "sSVDMC_pot",
                        "sSVDMC_mini", "DBSCAN_incr", "DBSCAN_centr"]


@pytest.mark.parametrize("approach", STREAMING_APPROACHES)
def test_streaming_approaches_run(modalities, approach):
    mods, mtypes, labels = modalities
    results, _ = api.get_initial_results()
    results = api.process_streaming_data(
        results=results, data_modalities=mods, modality_types=mtypes,
        window_size=64, reduced_dim=8, k_basis=3, n_clusters_total=2,
        seed=0, approach=approach, complete_true_labels=labels,
        step_window_ratio=1, noise_rate=0.5, label_mode="binary",
        sorting=True, eps=1.5, min_samples=2)
    assert len(results["f1_score"]) == 1
    assert 0.0 <= results["f1_score"][0] <= 1.0
    assert results["processing_time"][0] > 0
    # windows: 256 rows, window 64 -> 4 tumbling windows -> 256 labels scored
    assert results["nmi_score"][0] >= 0.0


@pytest.mark.parametrize("approach", ["SVDMC_batch", "DBSCAN_batch", "HDBSCAN_batch"])
def test_batch_approaches_run(modalities, approach):
    mods, mtypes, labels = modalities
    results, _ = api.get_initial_results()
    results = api.process_batch_data(
        results=results, data_modalities=mods, modality_types=mtypes,
        reduced_dim=8, k_basis=3, n_clusters=2, seed=0, approach=approach,
        complete_true_labels=labels, noise_rate=0.5, label_mode="binary",
        sorting=True, eps=1.5, min_samples=2, min_cluster_size=3,
        window_size=64)
    assert len(results["f1_score"]) == 1


def test_streaming_detects_planted_events():
    """On clean planted events with little noise, the full pipeline must beat
    chance decisively (binary event detection NMI)."""
    df = synthetic_events_dataframe(n_rows=380, n_events=3, noise_rate=0.4,
                                    seed=1)
    mods, mtypes, labels = prepare_modalities(df, subset_size=256,
                                              sort_by_uploaded=True,
                                              binary=False, event_types=True,
                                              noise_rate=0.3, seed=1)
    results, _ = api.get_initial_results()
    results = api.process_streaming_data(
        results=results, data_modalities=mods, modality_types=mtypes,
        window_size=128, reduced_dim=8, k_basis=4, n_clusters_total=4,
        seed=0, approach="sSVDMC", complete_true_labels=labels,
        step_window_ratio=1, noise_rate=0.3, label_mode="types",
        sorting=True, eps=1.5, min_samples=2)
    assert results["nmi_score"][0] > 0.15


@pytest.mark.slow
def test_swfd_vs_svd_comparable_quality():
    """SWFDMC's sketch-based reduction should land in the same quality
    ballpark as exact SVD reduction on the same stream."""
    df = synthetic_events_dataframe(n_rows=380, n_events=3, noise_rate=0.4,
                                    seed=2)
    mods, mtypes, labels = prepare_modalities(df, subset_size=256,
                                              sort_by_uploaded=True,
                                              binary=True, noise_rate=0.3,
                                              seed=2)
    scores = {}
    for approach in ("sSVDMC", "SWFDMC"):
        results, _ = api.get_initial_results()
        results = api.process_streaming_data(
            results=results, data_modalities=mods, modality_types=mtypes,
            window_size=128, reduced_dim=8, k_basis=4, n_clusters_total=2,
            seed=0, approach=approach, complete_true_labels=labels,
            step_window_ratio=1, noise_rate=0.3, label_mode="binary",
            sorting=True, eps=1.5, min_samples=2)
        scores[approach] = results["nmi_score"][0]
    assert scores["SWFDMC"] >= scores["sSVDMC"] - 0.25


def test_default_modality_synthetic_stream():
    """Single default-modality numeric stream (the synthetic .mat regime,
    reference data_loader.py:190-195)."""
    data = load_synthetic_dataset(subset_size=192, d=32)
    labels = np.zeros(192, int)
    labels[::3] = 1
    results, _ = api.get_initial_results()
    results = api.process_streaming_data(
        results=results, data_modalities=data, modality_types=["default"],
        window_size=64, reduced_dim=4, k_basis=3, n_clusters_total=2,
        seed=0, approach="SWFDMC", complete_true_labels=labels,
        step_window_ratio=1, noise_rate=0.0, label_mode="binary",
        sorting=False, eps=1.5, min_samples=2)
    assert len(results["f1_score"]) == 1


def test_sliding_window_mode(modalities):
    """step_window_ratio=2 fires twice per window span (overlapping windows)."""
    from mused_tpu.engine.streaming import window_triggers
    trig = window_triggers(subset_size=256, window_size=64, step_window_ratio=2)
    # reference trigger: (i+1)*2 % 64 == 0 and i+1 >= 64 -> every 32 rows
    assert trig == [i - 1 for i in range(64, 257, 32)]
    mods, mtypes, labels = modalities
    results, _ = api.get_initial_results()
    results = api.process_streaming_data(
        results=results, data_modalities=mods, modality_types=mtypes,
        window_size=64, reduced_dim=8, k_basis=3, n_clusters_total=2,
        seed=0, approach="sSVDMC", complete_true_labels=labels,
        step_window_ratio=2, noise_rate=0.5, label_mode="binary",
        sorting=True, eps=1.5, min_samples=2)
    assert len(results["f1_score"]) == 1


@pytest.mark.slow
def test_reference_opslevel_api(modalities):
    """The matrix_operations-level API surface also works standalone."""
    mods, mtypes, _ = modalities
    n = 48
    adjs = [api.create_adjacency_matrix(m[:n], t, k_basis=3)
            for m, t in zip(mods, mtypes)]
    for a in adjs:
        assert a.shape == (n, n)
        assert set(np.unique(a)) <= {0.0, 1.0}
    fused = api.fuse_matrices(adjs)
    assert fused.shape == (n, n)
    red = api.perform_svd_reduction(fused, 4, seed=0)
    assert red.shape == (n, 4)
    clusters = api.perform_clustering(red, 2, seed=0)
    assert set(np.unique(clusters)) <= {0, 1}


def test_sspectral_skips_unused_reduction():
    """Dense sSpectral's labels come from spectral_clustering(fused); with
    need_reduced=False (the engine default when not verbose) the per-window
    randomized SVD is skipped entirely — the returned reduced matrix has 0
    columns — without changing the labels."""
    import jax
    import jax.numpy as jnp
    from mused_tpu.engine.streaming import _window_step, StreamingEngine
    from mused_tpu.utils.config import PipelineConfig

    def run(need_reduced):
        eng = StreamingEngine(PipelineConfig(window_size=64, reduced_dim=8,
                                             approach="sSpectral",
                                             n_clusters_override=3))
        rng = np.random.default_rng(0)
        fused = jnp.asarray((rng.random((64, 64)) < 0.08).astype(np.float32))
        _, reduced, labels = _window_step(
            eng.state, fused, jnp.int32(3), jax.random.key(1),
            approach="sSpectral", k_basis=3, reduced_dim=8, k_max=4,
            window=64, fd_shrink="subspace",
            need_reduced=need_reduced)
        return np.asarray(reduced), np.asarray(labels)

    red_skip, lab_skip = run(False)
    red_full, lab_full = run(True)
    assert red_skip.shape == (64, 0)
    assert red_full.shape == (64, 8)
    np.testing.assert_array_equal(lab_skip, lab_full)


@pytest.mark.parametrize("approach",
                         ["SWFDMC", "sSVDMC", "sSVDMC_mini", "sSpectral"])
@pytest.mark.slow
def test_batched_windows_match_sequential(modalities, approach):
    """windows_per_batch > 1 must reproduce the sequential engine's metrics
    exactly: the scanned dispatch threads the real device state (SWFD ring,
    MiniBatch centroids) through the lax.scan carry, keeps the subspace
    shrink's gated cond a real branch, and pads the stream's tail group
    (batch_w=3 over 4 windows exercises the padding)."""
    from mused_tpu.utils.config import PipelineConfig
    mods, mtypes, labels = modalities
    out = {}
    for w in (1, 3):
        cfg = PipelineConfig(window_size=64, reduced_dim=8, k_basis=3,
                             approach=approach, label_mode="binary",
                             n_clusters_override=2, windows_per_batch=w)
        results, _ = api.get_initial_results()
        results = api.process_streaming_data(
            results=results, data_modalities=mods, modality_types=mtypes,
            window_size=64, reduced_dim=8, k_basis=3, n_clusters_total=2,
            seed=0, approach=approach, complete_true_labels=labels,
            step_window_ratio=1, noise_rate=0.5, label_mode="binary",
            sorting=True, eps=1.5, min_samples=2, cfg=cfg)
        out[w] = (results["nmi_score"][0], results["f1_score"][0])
    assert out[3][0] == pytest.approx(out[1][0], abs=1e-6)
    assert out[3][1] == pytest.approx(out[1][1], abs=1e-6)


@pytest.mark.parametrize("kw", [
    dict(window_size=512),            # window > subset: no windows fire
    dict(reduced_dim=100),            # reduced_dim > window
    dict(k_basis=100),                # k exceeds window rows (clamped)
    dict(window_size=256),            # subset == exactly one window
    dict(k_basis=1, reduced_dim=2),   # degenerate small graph
])
@pytest.mark.slow
def test_streaming_edge_configs_no_crash(modalities, kw):
    """Odd-but-legal configurations must run to completion (the reference's
    probe list: window_size > subset -> zero-window metrics, no crash;
    oversized k/reduced_dim clamp to the window)."""
    mods, mtypes, labels = modalities
    args = dict(window_size=64, reduced_dim=8, k_basis=3)
    args.update(kw)
    results, _ = api.get_initial_results()
    results = api.process_streaming_data(
        results=results, data_modalities=mods, modality_types=mtypes,
        n_clusters_total=2, seed=0, approach="SWFDMC",
        complete_true_labels=labels, step_window_ratio=1, noise_rate=0.5,
        label_mode="binary", sorting=True, eps=1.5, min_samples=2, **args)
    assert len(results["f1_score"]) == 1
    assert np.isfinite(results["f1_score"][0])


def test_batched_mode_records_swfd_R(modalities, monkeypatch):
    """The scanned dispatch records the reference's sketch bound R (first
    window's max squared row norm, ref main.py:61) identically to the
    per-window path — the batched paths previously skipped the diagnostic."""
    from mused_tpu.engine import streaming
    mods, mtypes, labels = modalities
    captured = {}
    orig_init = streaming.StreamingEngine.__init__

    def spy_init(self, cfg):
        orig_init(self, cfg)
        captured.setdefault("engines", []).append(self)

    monkeypatch.setattr(streaming.StreamingEngine, "__init__", spy_init)
    rs = {}
    for wpb in (1, 2):
        captured["engines"] = []
        results, _ = api.get_initial_results()
        api.process_streaming_data(
            results=results, data_modalities=mods, modality_types=mtypes,
            window_size=64, reduced_dim=8, k_basis=3, n_clusters_total=2,
            seed=0, approach="SWFDMC", complete_true_labels=labels,
            step_window_ratio=1, noise_rate=0.5, label_mode="binary",
            sorting=True, eps=1.5, min_samples=2, windows_per_batch=wpb)
        rs[wpb] = captured["engines"][0].swfd_R
    assert rs[1] is not None and rs[2] is not None
    assert rs[2] == pytest.approx(rs[1])


@pytest.mark.parametrize("k_estimate", ["fixed", "eigengap"])
@pytest.mark.slow
def test_label_free_k_estimate(modalities, k_estimate):
    """k_estimate='fixed'/'eigengap' runs the stream without consulting
    ground truth for the per-window cluster count (the reference leaks truth
    into k, main.py:41) and stays numerically identical between per-window
    and scanned dispatch."""
    from mused_tpu.utils.config import PipelineConfig
    mods, mtypes, labels = modalities

    def run(batch_w):
        cfg = PipelineConfig(window_size=64, reduced_dim=8, k_basis=3,
                             approach="SWFDMC", label_mode="binary",
                             n_clusters_override=4, k_estimate=k_estimate,
                             windows_per_batch=batch_w)
        r, _ = api.get_initial_results()
        return api.process_streaming_data(
            results=r, data_modalities=mods, modality_types=mtypes,
            window_size=64, reduced_dim=8, k_basis=3, n_clusters_total=4,
            seed=0, approach="SWFDMC", complete_true_labels=labels,
            step_window_ratio=1, noise_rate=0.5, label_mode="binary",
            sorting=True, eps=1.5, min_samples=2, cfg=cfg)

    r1, r4 = run(1), run(4)
    assert r1["nmi_score"] == r4["nmi_score"]
    assert r1["f1_score"] == r4["f1_score"]
    assert 0.0 <= r1["nmi_score"][0] <= 1.0


def test_k_estimate_validation(modalities):
    from mused_tpu.utils.config import PipelineConfig
    from mused_tpu.engine.streaming import StreamingEngine
    with pytest.raises(ValueError, match="k_estimate"):
        StreamingEngine(PipelineConfig(window_size=64, k_estimate="bogus"))


def test_windows_per_batch_auto_resolution():
    """windows_per_batch=None resolves to the platform's W
    (utils.runtime.platform_paths: 8 on the GPU, 1 on the CPU) for
    eligible configs; a stream of known length (n_windows passed) halves
    auto W while a quarter or more of its padded steps would be padding;
    explicit values always win."""
    from mused_tpu.engine.streaming import resolve_windows_per_batch
    from mused_tpu.utils.config import PipelineConfig
    from mused_tpu.utils.runtime import platform_paths
    base = PipelineConfig(approach="SWFDMC", window_size=64)
    kw = dict(standard_types=False)
    w_gpu = platform_paths("gpu").windows_per_batch
    assert w_gpu == 8
    assert resolve_windows_per_batch(base, backend="gpu", **kw) == w_gpu
    assert resolve_windows_per_batch(base, backend="cpu", **kw) == 1
    # the offline loop passes n_windows (serving doesn't and keeps W):
    # padded tail = 75 -> 80 keeps 8, 7 -> 8 keeps 8, 12 -> 16 halves to 4,
    # 9 -> 16 -> 12 -> 10 stops at 2, 3 windows run per-window
    for n_windows, want in ((75, 8), (8, 8), (7, 8), (16, 8), (12, 4),
                            (9, 2), (3, 1), (1, 1)):
        assert resolve_windows_per_batch(base, backend="gpu",
                                         n_windows=n_windows,
                                         **kw) == want, n_windows
    assert resolve_windows_per_batch(base, backend="cpu", n_windows=64,
                                     **kw) == 1
    # n_windows never changes an EXPLICIT W
    assert resolve_windows_per_batch(
        base.replace(windows_per_batch=4), backend="gpu", n_windows=64,
        **kw) == 4
    assert resolve_windows_per_batch(
        base.replace(windows_per_batch=8), backend="gpu", n_windows=9,
        **kw) == 8
    # explicit opt-out / explicit W win on any backend
    assert resolve_windows_per_batch(
        base.replace(windows_per_batch=1), backend="gpu", **kw) == 1
    assert resolve_windows_per_batch(
        base.replace(windows_per_batch=8), backend="cpu", **kw) == 8
    # ineligibility gates: host-clustered approach, sliding ratio,
    # checkpointing, verbose, huge windows, centroid-on-standard
    assert resolve_windows_per_batch(
        base.replace(approach="DBSCAN_incr"), backend="gpu", **kw) == 1
    assert resolve_windows_per_batch(
        base.replace(step_window_ratio=2), backend="gpu", **kw) == 1
    assert resolve_windows_per_batch(
        base, backend="gpu", checkpoint_dir="/tmp/x", **kw) == 1
    assert resolve_windows_per_batch(
        base.replace(verbose=True), backend="gpu", **kw) == 1
    assert resolve_windows_per_batch(
        base.replace(force_blocked_window=True), backend="gpu", **kw) == 1
    assert resolve_windows_per_batch(
        base.replace(matching="centroid"), backend="gpu",
        standard_types=True) == 1
    # the engine-arg ratio overrides the cfg field when provided
    assert resolve_windows_per_batch(base, backend="gpu",
                                     step_window_ratio=2, **kw) == 1
    # a platform without an entry is an error, not a silent default
    with pytest.raises(ValueError):
        resolve_windows_per_batch(base, backend="rocm", **kw)


def test_windows_per_batch_explicit_clamped_when_ineligible():
    """Explicit W>1 must clamp to per-window when the config can't run
    scanned at all — the scanned body has no host clustering glue, so a
    DBSCAN approach dispatched scanned would return placeholder labels
    (review r3 finding #1)."""
    from mused_tpu.engine.streaming import resolve_windows_per_batch
    from mused_tpu.utils.config import PipelineConfig
    base = PipelineConfig(approach="SWFDMC", window_size=64,
                          windows_per_batch=4)
    kw = dict(standard_types=False)
    assert resolve_windows_per_batch(base, backend="cpu", **kw) == 4
    assert resolve_windows_per_batch(
        base.replace(approach="DBSCAN_incr"), backend="gpu", **kw) == 1
    assert resolve_windows_per_batch(
        base.replace(approach="DBSCAN_centr"), backend="gpu", **kw) == 1
    assert resolve_windows_per_batch(
        base.replace(step_window_ratio=2), backend="gpu", **kw) == 1
    assert resolve_windows_per_batch(
        base.replace(force_blocked_window=True), backend="gpu", **kw) == 1
    # soft conditions (checkpointing) still compose with EXPLICIT W>1
    assert resolve_windows_per_batch(base, backend="cpu",
                                     checkpoint_dir="/tmp/x", **kw) == 4
