"""Multi-chip paths on the 8-virtual-device CPU mesh (SURVEY.md §4c)."""
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
import pytest

from mused_tpu.ops import fd, affinity
from mused_tpu.parallel import mesh as mesh_mod, sketch_merge, sharded


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return mesh_mod.make_mesh(n_data=8)


@pytest.fixture(scope="module")
def mesh4x2():
    return mesh_mod.make_mesh(n_data=4, n_model=2)


def test_merge_stacked_error_bound(rng):
    """Merged sketch of two shards obeys the additive FD merge bound."""
    d, ell = 64, 16
    a1 = rng.normal(size=(200, d)).astype(np.float32)
    a2 = rng.normal(size=(200, d)).astype(np.float32)
    s1 = fd.update_stream(fd.init(ell, d), jnp.asarray(a1)).sketch
    s2 = fd.update_stream(fd.init(ell, d), jnp.asarray(a2)).sketch
    merged, _ = sketch_merge.merge_stacked(jnp.stack([s1, s2]), ell)
    a = np.concatenate([a1, a2])
    err = float(fd.covariance_error(jnp.asarray(a), merged))
    bound = 2.0 * np.linalg.norm(a, "fro") ** 2 / ell
    assert err <= bound


@pytest.mark.parametrize("topology", ["allgather", "ring"])
def test_distributed_fd_over_mesh(rng, mesh8, topology):
    """Row-sharded FD over 8 devices: collective merge obeys the global bound."""
    n, d, ell = 512, 48, 16
    a = rng.normal(size=(n, d)).astype(np.float32)
    merged = sketch_merge.distributed_fd(jnp.asarray(a), ell=ell, mesh=mesh8,
                                         topology=topology)
    merged = np.asarray(merged)
    assert merged.shape == (ell, d)
    err = float(fd.covariance_error(jnp.asarray(a), jnp.asarray(merged)))
    # p local bounds + merge shrink: stay within a small multiple of ||A||_F^2/ell
    bound = 3.0 * np.linalg.norm(a, "fro") ** 2 / ell
    assert err <= bound


def test_distributed_matches_single_chip_quality(rng, mesh8):
    n, d, ell = 256, 32, 8
    a = rng.normal(size=(n, d)).astype(np.float32)
    single = fd.update_stream(fd.init(ell, d), jnp.asarray(a)).sketch
    multi = sketch_merge.distributed_fd(jnp.asarray(a), ell=ell, mesh=mesh8)
    e1 = float(fd.covariance_error(jnp.asarray(a), single))
    e2 = float(fd.covariance_error(jnp.asarray(a), multi))
    bound = np.linalg.norm(a, "fro") ** 2 / ell
    assert e2 <= 2.5 * bound and e1 <= bound


def test_global_max_row_norm(rng, mesh8):
    rows = rng.normal(size=(64, 16)).astype(np.float32)
    want = float(np.max(np.linalg.norm(rows, axis=1) ** 2))

    def body(shard):
        return sketch_merge.global_max_row_norm(shard)[None]

    got = jax.shard_map(body, mesh=mesh8, in_specs=P("data", None),
                        out_specs=P("data"), check_vma=False)(jnp.asarray(rows))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6)


@pytest.mark.slow
def test_sharded_fused_adjacency_matches_single_chip(rng, mesh8):
    """The explicitly-collective row-sharded adjacency must equal the
    single-device fused adjacency bit-for-bit (same masks, same top-k)."""
    n = 64
    loc = rng.uniform(-50, 50, size=(n, 2)).astype(np.float32)
    loc[5] = np.nan
    times = rng.uniform(1e9, 1.1e9, size=(n, 2)).astype(np.float32)
    times[9] = 0.0
    uids = rng.integers(-1, 6, size=n).astype(np.int32)
    tags = (rng.random((n, 64)) < 0.15).astype(np.float32)
    tags[3] = 0
    text = rng.poisson(0.1, size=(n, 128)).astype(np.float32)
    text[7] = 0

    single = affinity.multimodal_fused_adjacency(
        jnp.asarray(loc), jnp.asarray(times), jnp.asarray(uids),
        jnp.asarray(tags), jnp.asarray(text), k_basis=4)

    def body(l, t, u, g, x):
        return sharded._row_shard_fused_adjacency(l, t, u, g, x, 4)

    shard_fused = jax.shard_map(
        body, mesh=mesh8,
        in_specs=(P("data", None), P("data", None), P("data"),
                  P("data", None), P("data", None)),
        out_specs=P("data", None), check_vma=False,
    )(jnp.asarray(loc), jnp.asarray(times), jnp.asarray(uids),
      jnp.asarray(tags), jnp.asarray(text))

    np.testing.assert_array_equal(np.asarray(shard_fused), np.asarray(single))


def test_sharded_window_step_end_to_end(rng, mesh8):
    n = 64
    loc = rng.uniform(-50, 50, size=(n, 2)).astype(np.float32)
    times = rng.uniform(1e9, 1.1e9, size=(n, 2)).astype(np.float32)
    uids = rng.integers(0, 6, size=n).astype(np.int32)
    tags = (rng.random((n, 64)) < 0.15).astype(np.float32)
    text = rng.poisson(0.1, size=(n, 128)).astype(np.float32)
    labels, reduced = sharded.sharded_window_step(
        jnp.asarray(loc), jnp.asarray(times), jnp.asarray(uids),
        jnp.asarray(tags), jnp.asarray(text), jnp.int32(3),
        jax.random.key(0), k_basis=4, reduced_dim=8, k_max=4, mesh=mesh8)
    labels = np.asarray(labels)
    assert labels.shape == (n,)
    assert labels.max() < 3
    assert np.asarray(reduced).shape == (n, 8)


def test_sharded_kmeans_matches_single_chip(rng, mesh8):
    """Row-sharded Lloyd with psum'd centroids partitions blobs identically
    to the single-chip kernel (same init, fp reduction order aside)."""
    from sklearn.metrics import adjusted_rand_score
    from mused_tpu.ops import kmeans as km
    from mused_tpu.parallel.kmeans_sharded import kmeans_sharded
    centers = rng.normal(size=(4, 8)) * 6
    x = np.concatenate([c + rng.normal(size=(32, 8)) * 0.1 for c in centers])
    x = jnp.asarray(x.astype(np.float32))
    l1, _ = km.kmeans(x, jnp.int32(4), jax.random.key(0), k_max=6)
    l2, _ = kmeans_sharded(x, jnp.int32(4), jax.random.key(0), k_max=6,
                           mesh=mesh8)
    assert adjusted_rand_score(np.asarray(l1), np.asarray(l2)) == 1.0
    assert np.asarray(l2).max() < 4


@pytest.mark.slow
def test_parallel_sweep_matches_sequential(rng, mesh8):
    """Sweep points mapped across the 8 virtual devices reproduce the
    sequential results (each point is an independent pipeline run)."""
    from mused_tpu import api
    from mused_tpu.parallel.sweep import parallel_sweep
    from mused_tpu.data.synthetic import crisis_embedding_stream

    def point(noise_rate):
        mods, mtypes, labels = crisis_embedding_stream(
            n_rows=128, n_events=3, noise_rate=noise_rate, d_text=16,
            d_image=16, seed=2)
        results, _ = api.get_initial_results()
        results = api.process_streaming_data(
            results=results, data_modalities=mods, modality_types=mtypes,
            window_size=64, reduced_dim=8, k_basis=3, n_clusters_total=4,
            seed=0, approach="sSVDMC", complete_true_labels=labels,
            step_window_ratio=1, noise_rate=noise_rate, label_mode="all",
            sorting=False, eps=1.5, min_samples=2)
        return results["nmi_score"][0]

    rates = [0.2, 0.4, 0.6]
    seq = [point(r) for r in rates]
    par = parallel_sweep(point, rates)
    np.testing.assert_allclose(par, seq, atol=1e-6)


def test_sharded_step_on_2d_mesh(rng, mesh4x2):
    """The explicit data-parallel step also runs on a 2D (data, model) mesh
    (model axis replicated for the shard_map body)."""
    n = 32
    loc = rng.uniform(-50, 50, size=(n, 2)).astype(np.float32)
    times = rng.uniform(1e9, 1.1e9, size=(n, 2)).astype(np.float32)
    uids = rng.integers(0, 4, size=n).astype(np.int32)
    tags = (rng.random((n, 32)) < 0.2).astype(np.float32)
    text = rng.poisson(0.2, size=(n, 64)).astype(np.float32)
    labels, reduced = sharded.sharded_window_step(
        jnp.asarray(loc), jnp.asarray(times), jnp.asarray(uids),
        jnp.asarray(tags), jnp.asarray(text), jnp.int32(2),
        jax.random.key(0), k_basis=3, reduced_dim=4, k_max=2, mesh=mesh4x2)
    assert np.asarray(labels).shape == (n,)


# ---------------------------------------------------------------------------
# engine-level sharded mode (VERDICT r1 #1: the FULL pipeline on the mesh)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_stream():
    from mused_tpu import api
    from mused_tpu.data.synthetic import synthetic_events_dataframe
    df = synthetic_events_dataframe(n_rows=420, n_events=4, noise_rate=0.5,
                                    seed=0)
    return api.prepare_modalities(df, subset_size=256, sort_by_uploaded=True,
                                  binary=True, noise_rate=0.5, seed=0)


def _run_engine(engine_stream, approach, shards, **kw):
    from mused_tpu import api
    mods, mtypes, labels = engine_stream
    results, _ = api.get_initial_results()
    return api.process_streaming_data(
        results=results, data_modalities=mods, modality_types=mtypes,
        window_size=64, reduced_dim=8, k_basis=3, n_clusters_total=2,
        seed=0, approach=approach, complete_true_labels=labels,
        step_window_ratio=1, noise_rate=0.5, label_mode="binary",
        sorting=True, eps=1.5, min_samples=2, data_shards=shards, **kw)


@pytest.mark.parametrize("approach", ["sSVDMC", "sSVDMC_pot", "sSpectral"])
@pytest.mark.slow
def test_engine_sharded_metrics_match_single_chip(engine_stream, approach):
    """Deterministic-reduction approaches: the 8-device engine reproduces the
    single-chip metrics exactly (same randomized-SVD subspace up to fp
    reduction order; same host matching)."""
    one = _run_engine(engine_stream, approach, 1)
    eight = _run_engine(engine_stream, approach, 8)
    assert eight["f1_score"] == pytest.approx(one["f1_score"], abs=1e-6)
    assert eight["nmi_score"] == pytest.approx(one["nmi_score"], abs=1e-6)


@pytest.mark.parametrize("approach,topology", [("SWFDMC", "allgather"),
                                               ("SWFDMC", "ring"),
                                               ("sSVDMC_mini", "allgather"),
                                               ("DBSCAN_centr", "allgather"),
                                               ("DBSCAN_incr", "allgather")])
@pytest.mark.slow
def test_engine_sharded_all_approaches_run(engine_stream, approach, topology):
    """Sketch/stateful approaches: per-shard FD + sketch merge is a different
    (equally valid) FD sketch structure than single-chip, so parity is at the
    metric level: the sharded stream must cluster no worse than the
    all-noise baseline and produce finite metrics."""
    r = _run_engine(engine_stream, approach, 8, merge_topology=topology)
    assert len(r["f1_score"]) == 1
    assert np.isfinite(r["f1_score"][0]) and np.isfinite(r["nmi_score"][0])


@pytest.mark.slow
def test_engine_sharded_checkpoint_resume(tmp_path, engine_stream):
    """Crash + auto-resume under sharded mode == uninterrupted sharded run
    (device SWFD state, host matching state, metrics all restored)."""
    from mused_tpu import api
    from mused_tpu.engine import streaming
    mods, mtypes, labels = engine_stream
    straight = _run_engine(engine_stream, "SWFDMC", 8)

    ckdir = str(tmp_path / "swfd_sharded")
    orig = streaming.StreamingEngine.dispatch_window
    calls = {"n": 0}

    def bomb(self, *a, **k):
        if calls["n"] >= 2:
            raise KeyboardInterrupt("simulated crash")
        calls["n"] += 1
        return orig(self, *a, **k)

    streaming.StreamingEngine.dispatch_window = bomb
    try:
        with pytest.raises(KeyboardInterrupt):
            _run_engine(engine_stream, "SWFDMC", 8, checkpoint_dir=ckdir)
    finally:
        streaming.StreamingEngine.dispatch_window = orig

    resumed = _run_engine(engine_stream, "SWFDMC", 8, checkpoint_dir=ckdir)
    assert resumed["f1_score"] == pytest.approx(straight["f1_score"], abs=1e-6)
    assert resumed["nmi_score"] == pytest.approx(straight["nmi_score"], abs=1e-6)


def test_engine_sharded_rejects_bad_config(engine_stream):
    from mused_tpu.engine.streaming import StreamingEngine
    from mused_tpu.utils.config import PipelineConfig
    with pytest.raises(ValueError, match="divisible"):
        StreamingEngine(PipelineConfig(window_size=65, data_shards=8))
    with pytest.raises(ValueError, match="devices"):
        StreamingEngine(PipelineConfig(window_size=512, data_shards=512))


# ---------------------------------------------------------------------------
# sharded huge-window path (rematerialized blocked sweep over the mesh)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topology", ["allgather", "ring"])
@pytest.mark.slow
def test_sharded_blocked_fd_sketch_quality(rng, mesh8, topology):
    """Row-sharded blocked FD sweep + sketch merge: the merged sketch covers the
    implicit fused adjacency within the FD merge bound, and matches the
    single-chip blocked sketch's quality."""
    from mused_tpu.ops import blocked_affinity as ba
    n, block, ell, kb = 512, 32, 16, 4
    mats = [rng.normal(size=(n, 8)).astype(np.float32),
            rng.normal(size=(n, 12)).astype(np.float32)]
    cols = ba.generic_columns(mats, ("embedding", "default"))
    sk, sq, loss = sharded.sharded_blocked_fd_sketch(
        cols, ell=ell, block=block, k_basis=kb, mesh=mesh8, topology=topology)
    sk1, sq1, _ = ba.blocked_fd_sketch(cols, ell=ell, block=block, k_basis=kb)
    assert float(sq) == pytest.approx(float(sq1), rel=1e-5)

    full = np.concatenate([np.asarray(ba.fused_rowblock(cols, s, block, kb))
                           for s in range(0, n, block)])
    err = float(fd.covariance_error(jnp.asarray(full), sk))
    err1 = float(fd.covariance_error(jnp.asarray(full), sk1))
    bound = 2.0 * np.linalg.norm(full, "fro") ** 2 / ell
    assert err <= bound
    assert err <= 2.0 * max(err1, 1e-6) + 0.1 * bound   # comparable quality


def test_sharded_blocked_fd_rejects_uneven_blocks(rng, mesh8):
    from mused_tpu.ops import blocked_affinity as ba
    mats = [rng.normal(size=(96, 4)).astype(np.float32)]
    cols = ba.generic_columns(mats, ("default",))
    with pytest.raises(ValueError):
        sharded.sharded_blocked_fd_sketch(cols, ell=8, block=32, k_basis=2,
                                          mesh=mesh8)   # 3 blocks over 8


def test_sharded_blocked_fd_binned_select(rng, mesh8):
    """The fused stride-binned selection composes with the sharded sweep:
    at nbins == n it is exact, so the sharded binned sketch must equal the
    sharded strip sketch bit-for-bit (same per-chip fold order)."""
    from mused_tpu.ops import blocked_affinity as ba
    latlon = rng.uniform(low=(-60, -170), high=(60, 170),
                         size=(512, 2)).astype(np.float32)
    times = rng.uniform(low=1.0, high=1e6, size=(512, 2)).astype(np.float32)
    cols = ba.generic_columns([latlon, times], ("location", "time"))
    sk_s, sq_s, _ = sharded.sharded_blocked_fd_sketch(
        cols, ell=8, block=64, k_basis=3, mesh=mesh8)
    sk_b, sq_b, _ = sharded.sharded_blocked_fd_sketch(
        cols, ell=8, block=64, k_basis=3, mesh=mesh8,
        select="binned", nbins=512)
    np.testing.assert_array_equal(np.asarray(sk_s), np.asarray(sk_b))
    assert float(sq_s) == float(sq_b)


def _run_engine_blocked(engine_stream, approach, shards):
    from mused_tpu import api
    from mused_tpu.utils.config import PipelineConfig
    mods, mtypes, labels = engine_stream
    cfg = PipelineConfig(window_size=64, reduced_dim=8, k_basis=3,
                         approach=approach, label_mode="binary",
                         n_clusters_override=2, data_shards=shards,
                         force_blocked_window=True)
    results, _ = api.get_initial_results()
    return api.process_streaming_data(
        results=results, data_modalities=mods, modality_types=mtypes,
        window_size=64, reduced_dim=8, k_basis=3, n_clusters_total=2,
        seed=0, approach=approach, complete_true_labels=labels,
        step_window_ratio=1, noise_rate=0.5, label_mode="binary",
        sorting=True, eps=1.5, min_samples=2, cfg=cfg)


@pytest.mark.slow
def test_engine_huge_window_sharded(engine_stream):
    """SWFDMC on the forced-blocked (huge-window) path under data_shards=4:
    runs end-to-end on the mesh and clusters comparably to the single-chip
    blocked run (different valid sketch structure -> metric-level parity)."""
    one = _run_engine_blocked(engine_stream, "SWFDMC", 1)
    four = _run_engine_blocked(engine_stream, "SWFDMC", 4)
    assert np.isfinite(four["nmi_score"][0])
    assert four["f1_score"][0] >= one["f1_score"][0] - 0.15


def test_engine_huge_window_sharded_rejects_incr_dbscan(engine_stream):
    # every reduction now shards (SWFDMC sketch, sSVDMC-family SVD,
    # sSpectral embedding — test_colsharded.py); exact incremental DBSCAN
    # accumulates every point and stays dense-window-only
    with pytest.raises(ValueError):
        _run_engine_blocked(engine_stream, "DBSCAN_incr", 4)


@pytest.mark.slow
def test_elastic_resume_across_mesh_sizes(tmp_path, engine_stream):
    """Elastic recovery (SURVEY.md §5.3): a stream checkpointed under an
    8-device mesh resumes under a 4-device mesh (or single-chip).  For a
    deterministic-reduction approach the elastic resume reproduces the
    uninterrupted 8-device run's metrics exactly — the checkpointed device
    state is replicated, so it is mesh-shape-free."""
    from mused_tpu import api
    from mused_tpu.engine import streaming
    mods, mtypes, labels = engine_stream

    def run(shards, ckdir=None, stop_after=None):
        results, _ = api.get_initial_results()
        kwargs = dict(results=results, data_modalities=mods,
                      modality_types=mtypes, window_size=64, reduced_dim=8,
                      k_basis=3, n_clusters_total=2, seed=0,
                      approach="sSVDMC", complete_true_labels=labels,
                      step_window_ratio=1, noise_rate=0.5,
                      label_mode="binary", sorting=True, eps=1.5,
                      min_samples=2, data_shards=shards,
                      checkpoint_dir=ckdir)
        if stop_after is None:
            return api.process_streaming_data(**kwargs)
        orig = streaming.StreamingEngine.dispatch_window
        calls = {"n": 0}

        def bomb(self, *a, **k):
            if calls["n"] >= stop_after:
                raise KeyboardInterrupt()
            calls["n"] += 1
            return orig(self, *a, **k)

        streaming.StreamingEngine.dispatch_window = bomb
        try:
            with pytest.raises(KeyboardInterrupt):
                api.process_streaming_data(**kwargs)
        finally:
            streaming.StreamingEngine.dispatch_window = orig

    straight = run(8)
    ckdir = str(tmp_path / "elastic")
    run(8, ckdir=ckdir, stop_after=2)

    # count windows actually processed on resume: the checkpoint (2 windows
    # done of 4) must be honored — a silent from-scratch recompute would
    # still match the metrics (mesh-size determinism), so pin the skip
    orig = streaming.StreamingEngine.dispatch_window
    calls = {"n": 0}

    def counting(self, *a, **k):
        calls["n"] += 1
        return orig(self, *a, **k)

    streaming.StreamingEngine.dispatch_window = counting
    try:
        shrunk = run(4, ckdir=ckdir)      # resume on a SMALLER mesh
    finally:
        streaming.StreamingEngine.dispatch_window = orig
    assert calls["n"] == 2, "resume must process only the remaining windows"
    assert shrunk["nmi_score"][-1] == pytest.approx(straight["nmi_score"][-1],
                                                    abs=1e-6)
    assert shrunk["f1_score"][-1] == pytest.approx(straight["f1_score"][-1],
                                                   abs=1e-6)


@pytest.mark.parametrize("approach", ["SWFDMC", "sSVDMC", "sSVDMC_mini"])
@pytest.mark.slow
def test_engine_sharded_scanned_dispatch_matches_per_window(engine_stream,
                                                            approach):
    """windows_per_batch composed with data_shards: the scanned SPMD
    dispatch (sharded_scanned_steps) is numerically identical to per-window
    sharded dispatch — the scan body IS the per-window step and threads the
    same SWFD/MiniBatch carry."""
    per_window = _run_engine(engine_stream, approach, 4)
    scanned = _run_engine(engine_stream, approach, 4, windows_per_batch=2)
    assert scanned["f1_score"] == pytest.approx(per_window["f1_score"],
                                                abs=1e-6)
    assert scanned["nmi_score"] == pytest.approx(per_window["nmi_score"],
                                                 abs=1e-6)


@pytest.mark.slow
def test_engine_sharded_scanned_matches_single_chip_scanned(engine_stream):
    """Deterministic reductions: 8-device scanned == single-chip scanned."""
    one = _run_engine(engine_stream, "sSVDMC", 1, windows_per_batch=2)
    eight = _run_engine(engine_stream, "sSVDMC", 8, windows_per_batch=2)
    assert eight["f1_score"] == pytest.approx(one["f1_score"], abs=1e-6)
    assert eight["nmi_score"] == pytest.approx(one["nmi_score"], abs=1e-6)


@pytest.mark.slow
def test_sharded_eigengap_matches_single_chip():
    """k_estimate='eigengap' on the 8-device SPMD engine == single-chip for a
    deterministic-reduction approach: the estimate runs on the replicated
    reduced matrix, so the device count must not change the per-window
    cluster count.  (SWFDMC's sharded sketch has a different valid block
    structure — metric-level only, like the other SWFDMC parity tests.)"""
    from mused_tpu import api
    from mused_tpu.data.synthetic import synthetic_events_dataframe
    from mused_tpu.utils.config import PipelineConfig
    df = synthetic_events_dataframe(n_rows=900, n_events=4, noise_rate=0.6,
                                    seed=0)
    mods, mtypes, labels = api.prepare_modalities(
        df, subset_size=512, binary=True, sort_by_uploaded=True,
        noise_rate=0.5, seed=0)

    def run(shards):
        cfg = PipelineConfig(window_size=128, reduced_dim=16, k_basis=4,
                             approach="sSVDMC", label_mode="binary",
                             n_clusters_override=6, k_estimate="eigengap",
                             data_shards=shards)
        r, _ = api.get_initial_results()
        return api.process_streaming_data(
            results=r, data_modalities=mods, modality_types=mtypes,
            window_size=128, reduced_dim=16, k_basis=4, n_clusters_total=6,
            seed=0, approach="sSVDMC", complete_true_labels=labels,
            step_window_ratio=1, noise_rate=0.5, label_mode="binary",
            sorting=True, eps=1.5, min_samples=2, cfg=cfg)

    r1, r8 = run(1), run(8)
    assert r1["nmi_score"] == pytest.approx(r8["nmi_score"], abs=1e-6)
    assert r1["f1_score"] == pytest.approx(r8["f1_score"], abs=1e-6)
