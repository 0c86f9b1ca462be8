"""Column-sharded huge-window sweep (parallel/colsharded): the capacity
layout — feature tensors sharded over the mesh, per-chip binned candidates
merged over the interconnect, column-sharded FD fold with psum'd contractions.

Oracles: the single-chip binned path (ops/blocked_affinity.fused_rowblock
select="binned") for adjacency bit-exactness, the single-chip blocked FD
sketch for fold parity (same algorithm, psum summation order), and the FD
error bound for honesty.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mused_tpu.ops import blocked_affinity as ba, fd
from mused_tpu.parallel import colsharded as cs
from mused_tpu.parallel.mesh import make_mesh


@pytest.fixture
def mesh4():
    return make_mesh(n_data=4)


def _standard_window(rng, n=512, h_tags=256, h_text=512):
    from mused_tpu.data import features as feat
    loc = rng.uniform(low=(-60.0, -170.0), high=(60.0, 170.0),
                      size=(n, 2)).astype(np.float32)
    loc[rng.random(n) < 0.1] = np.nan
    tim = rng.uniform(1.0, 1e5, size=(n, 2)).astype(np.float32)
    tim[rng.random(n) < 0.1] = 0.0
    uid = rng.integers(0, 40, size=n).astype(np.int32)
    uid[rng.random(n) < 0.1] = -1
    tags = (rng.random((n, h_tags)) < 0.02).astype(np.uint8)
    text = rng.poisson(0.05, size=(n, h_text)).astype(np.uint8)
    tags_valid = rng.random(n) < 0.9
    return feat.WindowFeatures(location=loc, times=tim, user_ids=uid,
                               tags=tags, text=text, tags_valid=tags_valid)


def test_default_nbins_colsharded():
    # realistic engine geometry: n padded to block*p
    nb = cs.default_nbins_colsharded(106496, 4, k_max=9)
    assert nb and 106496 % nb == 0 and (106496 // 4) % nb == 0
    assert nb % 128 == 0 and 106496 // nb <= 127
    assert nb >= 8 * 9
    # tiny windows floor at g = p (each local column its own bin = exact)
    assert cs.default_nbins_colsharded(64, 4, k_max=9) == 16
    # p must divide n; group budget is int8
    assert cs.default_nbins_colsharded(100, 8) == 0
    assert cs.default_nbins_colsharded(256, 256) == 0
    # wide meshes past target_reduction still admit g = p (int8-safe)
    assert cs.default_nbins_colsharded(12800, 100) == 128


@pytest.mark.parametrize("start", [0, 192, 448])
@pytest.mark.slow
def test_colsharded_fused_rows_bitexact(rng, mesh4, start):
    """The column-sharded fused adjacency rows equal the single-chip binned
    path bit-for-bit: identical sims (contraction over the unsharded K),
    identical candidate maxima (pmax of per-shard maxima), identical tie
    winners (lowest global group via pmin of per-chip lowest achievers)."""
    wf = _standard_window(rng, n=512)
    cols = ba.standard_columns(wf)
    nbins, block, kb = 128, 64, 3
    ours = cs.colsharded_fused_rows(tuple(wf), ("standard",), start=start,
                                    block=block, k_basis=kb, mesh=mesh4,
                                    nbins=nbins)
    ref = ba.fused_rowblock(cols, jnp.int32(start), block, kb,
                            select="binned", nbins=nbins)
    np.testing.assert_array_equal(np.asarray(ours),
                                  np.asarray(ref) > 0)


@pytest.mark.parametrize("mode", ["eigh", "subspace"])
@pytest.mark.slow
def test_colsharded_fd_matches_singlechip(rng, mesh4, mode):
    """Column-sharded FD fold vs the single-chip blocked sketch on the SAME
    (bit-identical) adjacency blocks: the Frobenius bookkeeping is exact
    (integer sums), and the covariance B^T B agrees to rounding (the shrink
    math is identical; only psum summation order differs).  The honest
    error bound holds for the column-sharded sketch on its own."""
    wf = _standard_window(rng, n=512)
    cols = ba.standard_columns(wf)
    nbins, block, ell, kb = 128, 64, 16, 3
    sk, sq, loss = cs.colsharded_blocked_fd_sketch(
        tuple(wf), ("standard",), ell=ell, block=block, k_basis=kb,
        mesh=mesh4, mode=mode, nbins=nbins)
    sk1, sq1, loss1 = ba.blocked_fd_sketch(
        cols, ell=ell, block=block, k_basis=kb, mode=mode,
        select="binned", nbins=nbins)
    assert sk.shape == (ell, 512)
    assert float(sq) == pytest.approx(float(sq1), rel=1e-6)

    g = np.asarray(sk, np.float64).T @ np.asarray(sk, np.float64)
    g1 = np.asarray(sk1, np.float64).T @ np.asarray(sk1, np.float64)
    scale = max(np.abs(g1).max(), 1.0)
    np.testing.assert_allclose(g, g1, atol=5e-2 * scale)

    # honest bound: ||A^T A - B^T B||_2 <= min(sum deltas, ||A||_F^2/ell)
    full = np.concatenate(
        [np.asarray(ba.fused_rowblock(cols, jnp.int32(s), block, kb,
                                      select="binned", nbins=nbins))
         for s in range(0, 512, block)])
    err = float(fd.covariance_error(jnp.asarray(full), sk))
    bound = min(float(loss), float(sq) / ell)
    assert err <= bound * 1.01 + 1e-3


@pytest.mark.slow
def test_colsharded_generic_modalities(rng, mesh4):
    """Generic numeric streams (embedding + default euclidean) run on the
    columns layout; edges recall the exact strip path's at the reduced bin
    budget, and the FD bound holds."""
    n, block, kb = 256, 64, 4
    emb = rng.normal(size=(n, 32)).astype(np.float32)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    feats = (emb, x)
    types = ("embedding", "default")
    nbins = cs.default_nbins_colsharded(n, 4, k_max=3 * kb)
    assert nbins == 64          # g floored at p: exact per-chip selection

    ours = np.asarray(cs.colsharded_fused_rows(
        feats, types, start=64, block=block, k_basis=kb, mesh=mesh4,
        nbins=nbins))
    cols = ba.generic_columns(list(feats), types)
    exact = np.asarray(ba.fused_rowblock(cols, jnp.int32(64), block, kb)) > 0
    recall = (ours & exact).sum() / max(exact.sum(), 1)
    assert recall >= 0.8

    sk, sq, loss = cs.colsharded_blocked_fd_sketch(
        feats, types, ell=16, block=block, k_basis=kb, mesh=mesh4,
        nbins=nbins)
    assert np.isfinite(float(loss)) and float(sq) > 0


@pytest.mark.parametrize("mode", ["eigh", "subspace"])
@pytest.mark.slow
def test_grid_fd_matches_singlechip(rng, mode):
    """GRID layout (2 row groups x 4 column shards): per-group column-sharded
    folds + one merge shrink.  The adjacency blocks are still bit-exact, so
    B^T B matches the single-chip binned fold to rounding plus the (bounded,
    accounted) merge delta; the honest bound holds with the merge delta in."""
    mesh_grid = make_mesh(n_data=2, n_model=4)
    wf = _standard_window(rng, n=512)
    cols = ba.standard_columns(wf)
    nbins, block, ell, kb = 128, 64, 16, 3
    sk, sq, loss = cs.colsharded_blocked_fd_sketch(
        tuple(wf), ("standard",), ell=ell, block=block, k_basis=kb,
        mesh=mesh_grid, mode=mode, nbins=nbins)
    sk1, sq1, _ = ba.blocked_fd_sketch(
        cols, ell=ell, block=block, k_basis=kb, mode=mode,
        select="binned", nbins=nbins)
    assert sk.shape == (ell, 512)
    assert float(sq) == pytest.approx(float(sq1), rel=1e-6)

    full = np.concatenate(
        [np.asarray(ba.fused_rowblock(cols, jnp.int32(s), block, kb,
                                      select="binned", nbins=nbins))
         for s in range(0, 512, block)])
    err = float(fd.covariance_error(jnp.asarray(full), sk))
    err1 = float(fd.covariance_error(jnp.asarray(full), sk1))
    bound = min(float(loss), float(sq) / ell)
    assert err <= bound * 1.01 + 1e-3
    # comparable quality to the sequential single-chip fold (the merge adds
    # one bounded shrink — same argument as the row-sharded sketch merge)
    assert err <= 2.0 * max(err1, 1e-6) + 0.1 * float(sq) / ell


def test_grid_pd1_equals_pure_columns(rng):
    """A (1, pm) grid mesh IS pure column sharding: no row groups, so no
    merge shrink may run (a degenerate single-group 'merge' would
    spuriously subtract the smallest retained eigenvalue)."""
    wf = _standard_window(rng, n=512)
    kw = dict(ell=16, block=64, k_basis=3, mode="eigh", nbins=128)
    sk_g, sq_g, loss_g = cs.colsharded_blocked_fd_sketch(
        tuple(wf), ("standard",), mesh=make_mesh(n_data=1, n_model=4), **kw)
    sk_c, sq_c, loss_c = cs.colsharded_blocked_fd_sketch(
        tuple(wf), ("standard",), mesh=make_mesh(n_data=4, n_model=1), **kw)
    assert float(sq_g) == float(sq_c)
    assert float(loss_g) == pytest.approx(float(loss_c), rel=1e-6)
    g = np.asarray(sk_g, np.float64).T @ np.asarray(sk_g, np.float64)
    c = np.asarray(sk_c, np.float64).T @ np.asarray(sk_c, np.float64)
    np.testing.assert_allclose(g, c, atol=1e-4 * max(np.abs(c).max(), 1.0))


def test_colsharded_all_modalities_skipped(rng, mesh4):
    """k_eff == 0 for every modality (default kind, k_basis=1): zero-edge
    adjacency, matching the single-chip knn_adjacency_block k=0 case."""
    x = rng.normal(size=(256, 8)).astype(np.float32)
    out = np.asarray(cs.colsharded_fused_rows(
        (x,), ("default",), start=0, block=64, k_basis=1, mesh=mesh4,
        nbins=64))
    assert out.shape == (64, 256) and not out.any()


@pytest.mark.slow
def test_sharded_blocked_svd_matches_singlechip(rng, mesh4):
    """Row-sharded blocked randomized SVD (parallel/sharded): same omega
    stream and sweep recipe as the single-chip path — the reduced Gram
    agrees to rounding (summation order differs by the psums)."""
    from mused_tpu.parallel import sharded
    wf = _standard_window(rng, n=512)
    cols = ba.standard_columns(wf)
    key = jax.random.key(3)
    ours = np.asarray(sharded.sharded_blocked_svd_reduce(
        cols, key, rank=16, block=64, k_basis=3, mesh=mesh4), np.float64)
    ref = np.asarray(ba.blocked_svd_reduce(
        cols, key, rank=16, block=64, k_basis=3), np.float64)
    scale = max(np.abs(ref @ ref.T).max(), 1.0)
    np.testing.assert_allclose(ours @ ours.T, ref @ ref.T,
                               atol=1e-3 * scale)


@pytest.mark.slow
def test_colsharded_blocked_svd_matches_singlechip(rng, mesh4):
    """Column-sharded blocked randomized SVD: bit-identical fused blocks
    (binned select), so the reduced Gram matches the single-chip binned
    SVD to rounding."""
    wf = _standard_window(rng, n=512)
    cols = ba.standard_columns(wf)
    key = jax.random.key(3)
    nbins = 128
    ours = np.asarray(cs.colsharded_blocked_svd_reduce(
        tuple(wf), ("standard",), key, rank=16, block=64, k_basis=3,
        mesh=mesh4, nbins=nbins), np.float64)
    ref = np.asarray(ba.blocked_svd_reduce(
        cols, key, rank=16, block=64, k_basis=3, select="binned",
        nbins=nbins), np.float64)
    scale = max(np.abs(ref @ ref.T).max(), 1.0)
    np.testing.assert_allclose(ours @ ours.T, ref @ ref.T,
                               atol=1e-3 * scale)


@pytest.mark.slow
def test_sharded_spectral_matches_singlechip(rng, mesh4):
    """Row-sharded spectral embedding + the shared NJW tail clusters like
    the single-chip blocked spectral (same sweeps, psum rounding)."""
    from mused_tpu.parallel import sharded
    from mused_tpu.ops import blocked_spectral as bspec
    from mused_tpu.utils.metrics import nmi
    wf = _standard_window(rng, n=512)
    cols = ba.standard_columns(wf)
    key = jax.random.key(5)
    ritz, _ = sharded.sharded_spectral_embedding(
        cols, key, k_max=4, block=64, k_basis=3, mesh=mesh4)
    ours = np.asarray(bspec.labels_from_ritz(ritz, 3, key, k_max=4,
                                             n_real=512))
    ref = np.asarray(bspec.spectral_clustering_blocked(
        cols, 3, key, k_max=4, block=64, k_basis=3, n_real=512))
    assert nmi(ref, ours) >= 0.9


@pytest.mark.slow
def test_colsharded_spectral_runs(rng, mesh4):
    from mused_tpu.ops import blocked_spectral as bspec
    wf = _standard_window(rng, n=512)
    key = jax.random.key(5)
    ritz, lam = cs.colsharded_spectral_embedding(
        tuple(wf), ("standard",), key, k_max=4, block=64, k_basis=3,
        mesh=mesh4, nbins=128)
    labels = np.asarray(bspec.labels_from_ritz(ritz, 3, key, k_max=4,
                                               n_real=512))
    assert labels.shape == (512,) and len(np.unique(labels)) <= 4
    assert np.all(np.diff(np.asarray(lam)) <= 1e-5)   # descending spectrum


@pytest.mark.slow
def test_spectral_eigengap_recovers_planted_count(rng):
    """Label-free cluster counts at huge windows: the Ritz spectrum the
    blocked sweep already computes recovers a planted cluster count via
    the normalized-cuts eigengap (closes the former k_max-cap fallback)."""
    from mused_tpu.ops import blocked_spectral as bspec
    # k_basis >= 6: a 3-NN graph (k_basis=4) fragments inside clusters and
    # the cluster eigenvalues drift off 1 — the measured ratio at the true
    # boundary is 9-350x at k_basis 6-8 vs ~2x spurious elsewhere
    for c in (2, 3, 4, 5):
        centers = rng.normal(size=(c, 16)).astype(np.float32) * 8.0
        x = np.concatenate([centers[i] + rng.normal(
            size=(64, 16)).astype(np.float32) * 0.3 for i in range(c)])
        cols = ba.generic_columns([x], ("default",))
        _, lam = bspec.spectral_embedding_blocked(
            cols, jax.random.key(1), k_max=8, block=64, k_basis=6)
        k = int(bspec.eigengap_k_from_spectrum(lam, k_max=8))
        assert k == c, (c, k, np.asarray(lam)[:8])


@pytest.mark.slow
def test_colsharded_grid_svd_runs(rng):
    wf = _standard_window(rng, n=512)
    key = jax.random.key(3)
    out = cs.colsharded_blocked_svd_reduce(
        tuple(wf), ("standard",), key, rank=16, block=64, k_basis=3,
        mesh=make_mesh(n_data=2, n_model=4), nbins=128)
    assert out.shape == (512, 16) and np.isfinite(np.asarray(out)).all()


def test_colsharded_rejects_bad_geometry(rng, mesh4):
    wf = _standard_window(rng, n=512)
    with pytest.raises(ValueError, match="block"):
        cs.colsharded_blocked_fd_sketch(tuple(wf), ("standard",), ell=8,
                                        block=96, k_basis=3, mesh=mesh4)
    with pytest.raises(ValueError, match="eigh"):
        cs.colsharded_blocked_fd_sketch(tuple(wf), ("standard",), ell=8,
                                        block=64, k_basis=3, mesh=mesh4,
                                        mode="subspace_ns")
    # the int8 group budget guards EVERY entry point (shared geometry
    # validation — the spectral path once lacked it): 128/1 = 128 > 127
    with pytest.raises(ValueError, match="int8"):
        cs.colsharded_spectral_embedding(
            tuple(wf), ("standard",), jax.random.key(0), k_max=4,
            block=128, k_basis=3, mesh=mesh4, nbins=1)


# ---------------------------------------------------------------------------
# engine integration: huge_window_layout="columns"
# ---------------------------------------------------------------------------

@pytest.fixture
def engine_stream():
    from mused_tpu import api
    from mused_tpu.data.synthetic import synthetic_events_dataframe
    df = synthetic_events_dataframe(n_rows=420, n_events=4, noise_rate=0.5,
                                    seed=0)
    return api.prepare_modalities(df, subset_size=256, sort_by_uploaded=True,
                                  binary=True, noise_rate=0.5, seed=0)


def _run_engine_blocked(engine_stream, shards, layout="rows", col_shards=0,
                        approach="SWFDMC"):
    from mused_tpu import api
    from mused_tpu.utils.config import PipelineConfig
    mods, mtypes, labels = engine_stream
    cfg = PipelineConfig(window_size=64, reduced_dim=8, k_basis=3,
                         approach=approach, label_mode="binary",
                         n_clusters_override=2, data_shards=shards,
                         force_blocked_window=True,
                         huge_window_layout=layout,
                         huge_window_col_shards=col_shards)
    results, _ = api.get_initial_results()
    return api.process_streaming_data(
        results=results, data_modalities=mods, modality_types=mtypes,
        window_size=64, reduced_dim=8, k_basis=3, n_clusters_total=2,
        seed=0, approach=approach, complete_true_labels=labels,
        step_window_ratio=1, noise_rate=0.5, label_mode="binary",
        sorting=True, eps=1.5, min_samples=2, cfg=cfg)


@pytest.mark.slow
def test_engine_huge_window_columns_layout(engine_stream):
    """SWFDMC on the forced-blocked path with the features column-sharded
    over 4 chips: runs end-to-end and clusters comparably to the
    single-chip blocked run (binned vs strip selection -> metric-level)."""
    one = _run_engine_blocked(engine_stream, 1)
    col = _run_engine_blocked(engine_stream, 4, layout="columns")
    assert np.isfinite(col["nmi_score"][0])
    assert col["f1_score"][0] >= one["f1_score"][0] - 0.15


@pytest.mark.parametrize("layout,shards,col_shards",
                         [("rows", 4, 0), ("columns", 4, 0),
                          ("grid", 4, 2)])
@pytest.mark.slow
def test_engine_huge_window_sharded_svd(engine_stream, layout, shards,
                                        col_shards):
    """sSVDMC (randomized-SVD reduction) on the forced-blocked path across
    all three sharded layouts — previously rejected outright for non-SWFDMC
    approaches."""
    one = _run_engine_blocked(engine_stream, 1, approach="sSVDMC")
    sh = _run_engine_blocked(engine_stream, shards, layout=layout,
                             col_shards=col_shards, approach="sSVDMC")
    assert np.isfinite(sh["nmi_score"][0])
    assert sh["f1_score"][0] >= one["f1_score"][0] - 0.15


@pytest.mark.parametrize("layout,col_shards", [("rows", 0), ("columns", 0),
                                               ("grid", 2)])
@pytest.mark.slow
def test_engine_huge_window_sharded_spectral(engine_stream, layout,
                                             col_shards):
    """sSpectral (blocked normalized cuts) on the forced-blocked path
    across all three sharded layouts."""
    one = _run_engine_blocked(engine_stream, 1, approach="sSpectral")
    sh = _run_engine_blocked(engine_stream, 4, layout=layout,
                             col_shards=col_shards, approach="sSpectral")
    assert np.isfinite(sh["nmi_score"][0])
    assert sh["f1_score"][0] >= one["f1_score"][0] - 0.15


@pytest.mark.slow
def test_engine_huge_window_grid_layout(engine_stream):
    """The grid composition end-to-end: 2 row groups x 2 column shards."""
    one = _run_engine_blocked(engine_stream, 1)
    grid = _run_engine_blocked(engine_stream, 4, layout="grid", col_shards=2)
    assert np.isfinite(grid["nmi_score"][0])
    assert grid["f1_score"][0] >= one["f1_score"][0] - 0.15


def test_engine_columns_layout_validation(engine_stream):
    from mused_tpu.engine.streaming import StreamingEngine
    from mused_tpu.utils.config import PipelineConfig
    with pytest.raises(ValueError, match="huge_window_layout"):
        StreamingEngine(PipelineConfig(window_size=64,
                                       huge_window_layout="diagonal"))
    with pytest.raises(ValueError, match="contradictory"):
        StreamingEngine(PipelineConfig(window_size=64,
                                       huge_window_layout="columns",
                                       huge_window_fused_select=False))
    with pytest.raises(ValueError, match="col_shards"):
        StreamingEngine(PipelineConfig(window_size=64, data_shards=4,
                                       force_blocked_window=True,
                                       approach="SWFDMC",
                                       huge_window_layout="grid",
                                       huge_window_col_shards=3))
    with pytest.raises(ValueError, match="dense windows"):
        StreamingEngine(PipelineConfig(window_size=64, data_shards=4,
                                       huge_window_layout="grid",
                                       huge_window_col_shards=2))
    # columns on dense windows / one chip must be loud, not silently 'rows'
    with pytest.raises(ValueError, match="dense windows"):
        StreamingEngine(PipelineConfig(window_size=64, data_shards=4,
                                       huge_window_layout="columns"))
    with pytest.raises(ValueError, match="data_shards > 1"):
        StreamingEngine(PipelineConfig(window_size=64,
                                       force_blocked_window=True,
                                       approach="SWFDMC",
                                       huge_window_layout="columns"))
    # prime data_shards has no balanced auto grid factorization
    with pytest.raises(ValueError, match="factorization"):
        StreamingEngine(PipelineConfig(window_size=70, data_shards=7,
                                       force_blocked_window=True,
                                       approach="SWFDMC",
                                       huge_window_layout="grid"))


@pytest.mark.slow
def test_colsharded_cand_fold_matches_dense(rng, mesh4):
    """Candidate-native colsharded fold (VERDICT r3 next #6): forced
    cand_fold=True (XLA reference products on the CPU mesh) vs the dense
    colsharded fold on the SAME merged candidates — identical edge
    bookkeeping (sq is the exact integer edge count both ways), covariance
    agreement to probe rounding (same relationship as the single-chip
    cand-vs-dense fold), and the honest bound holds.  Also pins colsharded
    cand vs SINGLE-CHIP cand fold: same algorithm, psum order only."""
    wf = _standard_window(rng, n=512)
    cols = ba.standard_columns(wf)
    nbins, block, ell, kb = 128, 64, 16, 3
    sk_c, sq_c, loss_c = cs.colsharded_blocked_fd_sketch(
        tuple(wf), ("standard",), ell=ell, block=block, k_basis=kb,
        mesh=mesh4, mode="subspace", nbins=nbins, cand_fold=True)
    sk_d, sq_d, loss_d = cs.colsharded_blocked_fd_sketch(
        tuple(wf), ("standard",), ell=ell, block=block, k_basis=kb,
        mesh=mesh4, mode="subspace", nbins=nbins, cand_fold=False)
    sk_1, sq_1, _ = ba.blocked_fd_sketch(
        cols, ell=ell, block=block, k_basis=kb, mode="subspace",
        select="binned", nbins=nbins, cand_fold=True)
    # exact integer edge-count bookkeeping, all three ways
    assert float(sq_c) == pytest.approx(float(sq_d), rel=1e-6)
    assert float(sq_c) == pytest.approx(float(sq_1), rel=1e-6)

    g_c = np.asarray(sk_c, np.float64).T @ np.asarray(sk_c, np.float64)
    g_d = np.asarray(sk_d, np.float64).T @ np.asarray(sk_d, np.float64)
    g_1 = np.asarray(sk_1, np.float64).T @ np.asarray(sk_1, np.float64)
    scale = max(np.abs(g_d).max(), 1.0)
    np.testing.assert_allclose(g_c, g_d, atol=5e-2 * scale)
    np.testing.assert_allclose(g_c, g_1, atol=5e-2 * scale)

    # honest bound for the candidate-native colsharded sketch on its own
    full = np.concatenate(
        [np.asarray(ba.fused_rowblock(cols, jnp.int32(s), block, kb,
                                      select="binned", nbins=nbins))
         for s in range(0, 512, block)])
    err = float(fd.covariance_error(jnp.asarray(full), sk_c))
    bound = min(float(loss_c), float(sq_c) / ell)
    assert err <= bound * 1.01 + 1e-3


@pytest.mark.slow
def test_grid_cand_fold(rng):
    """Cand fold on the GRID layout (2 row groups x 4 column shards): the
    per-group sweeps absorb candidates, the cross-group merge shrink stays
    dense.  Edge bookkeeping matches the dense grid fold exactly; the
    sketches themselves are compared on what matters — both satisfy the
    honest FD bound and land at comparable covariance error vs the TRUE
    dense adjacency (at this toy scale loss/sq ~ 0.75, so the retained
    signal is tiny and elementwise covariance closeness is dominated by
    probe rounding: measured cand 173.3 vs dense 178.9 at bound 852)."""
    mesh_grid = make_mesh(n_data=2, n_model=4)
    wf = _standard_window(rng, n=512)
    cols = ba.standard_columns(wf)
    nbins, block, ell, kb = 128, 64, 16, 3
    kw = dict(ell=ell, block=block, k_basis=kb, mesh=mesh_grid,
              mode="subspace", nbins=nbins)
    sk_c, sq_c, loss_c = cs.colsharded_blocked_fd_sketch(
        tuple(wf), ("standard",), cand_fold=True, **kw)
    sk_d, sq_d, loss_d = cs.colsharded_blocked_fd_sketch(
        tuple(wf), ("standard",), cand_fold=False, **kw)
    assert float(sq_c) == pytest.approx(float(sq_d), rel=1e-6)
    full = np.concatenate(
        [np.asarray(ba.fused_rowblock(cols, jnp.int32(s), block, kb,
                                      select="binned", nbins=nbins))
         for s in range(0, 512, block)])
    err_c = float(fd.covariance_error(jnp.asarray(full), sk_c))
    err_d = float(fd.covariance_error(jnp.asarray(full), sk_d))
    bound = min(float(loss_c), float(sq_c) / ell)
    assert err_c <= bound * 1.01 + 1e-3
    assert err_c <= err_d * 1.10 + 1e-3, (err_c, err_d)


@pytest.mark.slow
def test_colsharded_cand_fold_generic_no_user(rng, mesh4):
    """Generic embedding streams (no username modality) run the colsharded
    cand fold: dummy uid_cols carry the geometry; edges match dense."""
    n, block, kb = 256, 64, 4
    emb = rng.normal(size=(n, 32)).astype(np.float32)
    feats = (emb,)
    types = ("embedding",)
    nbins = cs.default_nbins_colsharded(n, 4, k_max=3 * kb)
    kw = dict(ell=16, block=block, k_basis=kb, mesh=mesh4, nbins=nbins,
              mode="subspace")
    sk_c, sq_c, _ = cs.colsharded_blocked_fd_sketch(
        feats, types, cand_fold=True, **kw)
    sk_d, sq_d, _ = cs.colsharded_blocked_fd_sketch(
        feats, types, cand_fold=False, **kw)
    assert float(sq_c) == pytest.approx(float(sq_d), rel=1e-6)
    g_c = np.asarray(sk_c, np.float64).T @ np.asarray(sk_c, np.float64)
    g_d = np.asarray(sk_d, np.float64).T @ np.asarray(sk_d, np.float64)
    scale = max(np.abs(g_d).max(), 1.0)
    np.testing.assert_allclose(g_c, g_d, atol=5e-2 * scale)


def test_default_nbins_capacity_scale_fits_budgets():
    """The resolver must produce a compilable geometry at the ~1M-row
    capacity windows the columns layout exists for: per-chip int8 group
    ids and (block, nbins) candidate buffers of at most 4096 bins."""
    from mused_tpu.parallel.colsharded import default_nbins_colsharded
    for n, p in ((1_048_576, 8), (524_288, 4), (98_304, 8)):
        nbins = default_nbins_colsharded(n, p)
        assert nbins > 0, (n, p)
        g = n // nbins
        assert g % p == 0 and n % g == 0
        assert g // p <= 127, (n, p, g)              # per-chip int8 ids
        assert nbins <= 4096, (n, p, nbins)          # candidate buffers
    # small-n behavior unchanged (the existing parity fixtures)
    assert default_nbins_colsharded(512, 8) == 8
