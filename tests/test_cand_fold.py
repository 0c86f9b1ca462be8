"""Candidate-native huge-window FD fold (ops/cand_matvec +
blocked_affinity.candidate_rowblock + fd.shrink_rr_cands).

The fold's products rebuild the adjacency one column group at a time from
int8 candidate slabs.  Edges must equal the dense binned path EXACTLY (same
candidates + budgeted_keep + username equality); products agree to f32
rounding; the FD bound stays a true upper bound on the sketch's covariance
error.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mused_tpu.ops import blocked_affinity as ba, fd
from mused_tpu.ops import cand_matvec as cm


def _standard_cols(n=256, seed=0, noise=0.5):
    from mused_tpu.data.synthetic import synthetic_events_dataframe
    from mused_tpu.data.sed2012 import prepare_modalities
    from mused_tpu.data import features as feat
    from mused_tpu.utils.config import FeatureConfig
    df = synthetic_events_dataframe(n_rows=n + 64, n_events=4,
                                    noise_rate=noise, seed=seed)
    mods, _, _ = prepare_modalities(df, subset_size=n, binary=True,
                                    sort_by_uploaded=False, noise_rate=noise,
                                    seed=seed)
    fc = FeatureConfig()
    wf = feat.featurize_window(*mods, fc)
    return ba.standard_columns(wf, fc)


def _random_cand(rng, n_mod=3, block=64, nbins=128, groups=4,
                 with_user=True):
    slabs = jnp.asarray(
        rng.integers(-1, groups, (n_mod, block, nbins)).astype(np.int8))
    if with_user:
        uid_r = jnp.asarray(
            rng.integers(-1, 6, (block, 1)).astype(np.int32))
        uid_c = jnp.asarray(
            rng.integers(-2, 6, (groups, nbins)).astype(np.int32))
    else:
        uid_r = None
        uid_c = jnp.full((groups, nbins), -2, jnp.int32)
    return cm.CandBlock(slabs, uid_r, uid_c, jnp.int32(64))


def _dense_oracle(cand) -> np.ndarray:
    """NumPy (block, n) 0/1 fused rows of a CandBlock: column g*nbins + s
    is an edge when any slab keeps group g in slot s, or (username) when the
    row's and column's uids match and it is not the row's own column."""
    slabs = np.asarray(cand.slabs)
    _, block, nbins = slabs.shape
    groups = np.asarray(cand.uid_cols).shape[0]
    dense = np.zeros((block, groups * nbins), np.float32)
    for g in range(groups):
        dense[:, g * nbins:(g + 1) * nbins] = (slabs == g).any(axis=0)
    if cand.uid_rows is not None:
        ur = np.asarray(cand.uid_rows)[:, 0]
        uc = np.asarray(cand.uid_cols).reshape(-1)
        same = ur[:, None] == uc[None, :]
        rows = int(cand.start) + np.arange(block)
        same &= rows[:, None] != np.arange(groups * nbins)[None, :]
        dense = np.maximum(dense, same.astype(np.float32))
    return dense


@pytest.mark.parametrize("with_user", [True, False])
def test_reference_products_match_dense(with_user):
    """The per-group products equal plain dense matmuls of the NumPy union
    adjacency (integer operands -> exact), with and without the username
    modality."""
    rng = np.random.default_rng(1)
    cand = _random_cand(rng, with_user=with_user)
    dense = _dense_oracle(cand)
    np.testing.assert_array_equal(np.asarray(cm.dense_rows(cand)), dense > 0)
    n = dense.shape[1]
    # username equality must never add a self edge: row i's global column
    # is 64+i (group 0, slot 64+i), so unless some slab itself keeps that
    # slot with group id 0, the self entry stays 0 even when uids match
    slabs = np.asarray(cand.slabs)
    for i in range(dense.shape[0]):
        if not (slabs[:, i, 64 + i] == 0).any():
            assert dense[i, 64 + i] == 0.0
    x = rng.integers(-4, 5, (128, 64)).astype(np.float32)
    out, edges = cm.matvec_t(cand, jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(np.asarray(out), x @ dense)
    assert float(edges) == dense.sum()
    y = rng.integers(-4, 5, (n, 128)).astype(np.float32)
    got = cm.matvec(cand, jnp.asarray(y).astype(jnp.bfloat16))
    np.testing.assert_array_equal(np.asarray(got), dense @ y)


@pytest.mark.parametrize("with_user", [True, False])
def test_products_match_dense_float_operands(with_user):
    """Real-valued probes (the fold's bf16 operands): the per-group
    products equal the dense product of the bf16-rounded operand to f32
    summation rounding."""
    rng = np.random.default_rng(2)
    cand = _random_cand(rng, with_user=with_user)
    dense = _dense_oracle(cand)
    x = jnp.asarray(rng.standard_normal((80, 64)), jnp.bfloat16)
    y = jnp.asarray(rng.standard_normal((dense.shape[1], 80)), jnp.bfloat16)
    out, _ = cm.matvec_t(cand, x)
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(x, np.float64) @ dense,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(cm.matvec(cand, y)),
                               dense @ np.asarray(y, np.float64),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.slow
def test_candidate_rowblock_matches_fused_rowblock():
    """Candidate blocks expand to EXACTLY the dense binned fused block
    (same candidates, same budgeted_keep, username equality included)."""
    cols = _standard_cols()
    n = cols.n
    nbins = n // 2
    assert ba.cand_fold_supported(cols.kinds, cols.tensors, nbins, n)
    for start in (0, 64, 192):
        cand = ba.candidate_rowblock(cols, jnp.int32(start), 64, 5, nbins)
        dense = ba.fused_rowblock(cols, jnp.int32(start), 64, 5,
                                  select="binned", nbins=nbins)
        np.testing.assert_array_equal(
            np.asarray(cm.dense_rows(cand)),
            np.asarray(dense) > 0)


@pytest.mark.slow
def test_cand_fold_matches_dense_fold():
    """Full blocked_fd_sketch: forced cand_fold vs the dense rr fold —
    identical edge mass (sq_frobenius is an integer edge count) and close
    sketch Grams (product precisions differ by bf16 probe rounding)."""
    cols = _standard_cols()
    n = cols.n
    sk_d, sq_d, loss_d = ba.blocked_fd_sketch(
        cols, ell=16, block=64, k_basis=5, mode="subspace",
        select="binned", nbins=n // 2, cand_fold=False)
    sk_c, sq_c, loss_c = ba.blocked_fd_sketch(
        cols, ell=16, block=64, k_basis=5, mode="subspace",
        select="binned", nbins=n // 2, cand_fold=True)
    assert float(sq_d) == float(sq_c)
    gd = np.asarray(sk_d).T @ np.asarray(sk_d)
    gc = np.asarray(sk_c).T @ np.asarray(sk_c)
    assert np.linalg.norm(gd - gc) / max(np.linalg.norm(gd), 1e-9) < 0.15
    assert abs(float(loss_d) - float(loss_c)) / max(float(loss_d), 1.0) < 0.1


def test_cand_fold_bound_oracle():
    """The telescoped trace-residual bound must upper-bound the measured
    covariance error of the cand-fold sketch vs the TRUE dense fused
    adjacency (the honest-accounting contract of fd.shrink_rr)."""
    cols = _standard_cols()
    n = cols.n
    nbins = n // 2
    sk, sq, loss = ba.blocked_fd_sketch(
        cols, ell=24, block=64, k_basis=5, mode="subspace",
        select="binned", nbins=nbins, cand_fold=True)
    a = np.concatenate([np.asarray(ba.fused_rowblock(
        cols, jnp.int32(s), 64, 5, select="binned", nbins=nbins))
        for s in range(0, n, 64)])
    assert float(sq) == a.sum()            # 0/1 edges: ||A||_F^2 == count
    err = float(fd.covariance_error(jnp.asarray(a), sk))
    bound = min(float(loss), float(sq) / 24)
    assert err <= bound * 1.01, (err, bound)


def test_cand_fold_gating():
    """Eligibility: forced True with a strip-only kind raises, and so does
    the eigh shrink."""
    cols = _standard_cols()
    n = cols.n
    # text_split has no candidate route
    kinds = tuple("text_split" if k == "text_bf16" else k
                  for k in cols.kinds)
    bad = ba.Columns(kinds=kinds, tensors=cols.tensors, valids=cols.valids,
                     idf=cols.idf)
    assert not ba.cand_fold_supported(bad.kinds, bad.tensors, n // 2, n)
    with pytest.raises(ValueError):
        ba.blocked_fd_sketch(bad, ell=16, block=64, k_basis=5,
                             mode="subspace", select="binned", nbins=n // 2,
                             cand_fold=True)
    # eigh mode is ineligible too (the cand fold is rr-only)
    with pytest.raises(ValueError):
        ba.blocked_fd_sketch(cols, ell=16, block=64, k_basis=5,
                             mode="eigh", select="binned", nbins=n // 2,
                             cand_fold=True)


@pytest.mark.slow
def test_cand_fold_generic_kinds():
    """Generic numeric streams (embedding/default, no username): the cand
    fold must route, select EXACTLY the dense fold's edges, and keep the
    honest bound contract (sketch-to-sketch Grams are NOT compared — the
    randomized shrink's bf16 probe rounding picks a different but equally
    valid subspace on these near-full-rank kNN graphs)."""
    rng = np.random.default_rng(3)
    n = 256
    emb = rng.standard_normal((n, 96)).astype(np.float32)
    dflt = (rng.standard_normal((n, 24)) * 3).astype(np.float32)
    cols = ba.generic_columns([emb, dflt], ("embedding", "default"))
    nbins = n // 2
    assert ba.cand_fold_supported(cols.kinds, cols.tensors, nbins, n)
    _, sq_d, loss_d = ba.blocked_fd_sketch(
        cols, ell=16, block=64, k_basis=5, mode="subspace",
        select="binned", nbins=nbins, cand_fold=False)
    sk_c, sq_c, loss_c = ba.blocked_fd_sketch(
        cols, ell=16, block=64, k_basis=5, mode="subspace",
        select="binned", nbins=nbins, cand_fold=True)
    assert float(sq_d) == float(sq_c)          # identical edge selection
    a = np.concatenate([np.asarray(ba.fused_rowblock(
        cols, jnp.int32(s), 64, 5, select="binned", nbins=nbins))
        for s in range(0, n, 64)])
    assert float(sq_c) == a.sum()
    err = float(fd.covariance_error(jnp.asarray(a), sk_c))
    bound = min(float(loss_c), float(sq_c) / 16)
    assert err <= bound * 1.01, (err, bound)
    # the cand fold's accounted loss stays in the dense fold's ballpark
    assert float(loss_c) <= 1.5 * float(loss_d) + 1.0


@pytest.mark.slow
def test_engine_huge_window_cand_fold_metric_parity():
    """Engine-level end-metric oracle (VERDICT r3 next #1): a forced-blocked
    SWFDMC stream over a fixture with RECOVERABLE planted events (sorted
    stream + all-ids labels, the BENCH_DETAIL 3b oracle config at test
    scale) must score the SAME with the candidate-native fold ON and OFF —
    and must actually recover the events, so a numerics regression in
    cand_matvec / shrink_rr_cands / binned selection moves a real metric
    instead of perturbing seed-luck noise (the old binary/unsorted fixture
    sat at NMI ~= 0 where the fold's numerics were invisible).

    Measured on this fixture: NMI 0.515, NMI_e 0.857, identical ON vs OFF
    to 4 decimals."""
    from mused_tpu import api
    from mused_tpu.utils.config import PipelineConfig
    from mused_tpu.data.synthetic import synthetic_events_dataframe
    from mused_tpu.data.sed2012 import prepare_modalities
    df = synthetic_events_dataframe(n_rows=4096, n_events=6, noise_rate=0.5,
                                    seed=0)
    mods, mtypes, labels = prepare_modalities(
        df, subset_size=2048, binary=False, event_types=False,
        sort_by_uploaded=True, noise_rate=0.8, seed=0)

    def run(cand_fold):
        cfg = PipelineConfig(
            window_size=512, reduced_dim=16, k_basis=8, approach="SWFDMC",
            label_mode="all", n_clusters_override=150,
            force_blocked_window=True, huge_window_fused_select=True,
            huge_window_cand_fold=cand_fold)
        results, _ = api.get_initial_results()
        return api.process_streaming_data(
            results=results, data_modalities=mods, modality_types=mtypes,
            window_size=512, reduced_dim=16, k_basis=8, n_clusters_total=150,
            seed=0, approach="SWFDMC", complete_true_labels=labels,
            step_window_ratio=1, noise_rate=0.8, label_mode="all",
            sorting=True, eps=1.5, min_samples=2, cfg=cfg)

    r_d, r_c = run(False), run(True)
    # the fold is a different factorization of the same absorb: end metrics
    # agree tightly (identical on this fixture; tolerance covers future
    # benign reorderings)
    assert abs(r_d["nmi_score"][0] - r_c["nmi_score"][0]) < 0.02, \
        (r_d["nmi_score"], r_c["nmi_score"])
    assert abs(r_d["nmi_e_score"][0] - r_c["nmi_e_score"][0]) < 0.02
    # ... and both actually recover the planted events (the oracle part)
    assert r_d["nmi_e_score"][0] > 0.5, r_d["nmi_e_score"]
    assert r_c["nmi_e_score"][0] > 0.5, r_c["nmi_e_score"]


@pytest.mark.slow
def test_sharded_cand_fold_matches_single_chip():
    """Row-sharded SPMD sweep with the candidate-native fold: per-shard
    absorbs run off the slabs and the merged sketch selects EXACTLY the
    same edges as
    the single-chip cand fold, within the FD merge bound."""
    from mused_tpu.parallel import mesh as mesh_mod, sharded
    cols = _standard_cols()
    n = cols.n
    nbins, block, ell = n // 2, 32, 16
    mesh8 = mesh_mod.make_mesh(n_data=8)
    sk_s, sq_s, _ = sharded.sharded_blocked_fd_sketch(
        cols, ell=ell, block=block, k_basis=5, mesh=mesh8,
        select="binned", nbins=nbins, cand_fold=True)
    sk_1, sq_1, _ = ba.blocked_fd_sketch(
        cols, ell=ell, block=block, k_basis=5, mode="subspace",
        select="binned", nbins=nbins, cand_fold=True)
    assert float(sq_s) == float(sq_1)      # identical integer edge mass
    a = np.concatenate([np.asarray(ba.fused_rowblock(
        cols, jnp.int32(s), block, 5, select="binned", nbins=nbins))
        for s in range(0, n, block)])
    assert float(sq_s) == a.sum()
    err = float(fd.covariance_error(jnp.asarray(a), sk_s))
    assert err <= 2.0 * a.sum() / ell      # FD merge bound (0/1 edges)
    # gating: strip select can't run the cand fold
    import pytest as _pytest
    with _pytest.raises(ValueError):
        sharded.sharded_blocked_fd_sketch(
            cols, ell=ell, block=block, k_basis=5, mesh=mesh8,
            cand_fold=True)


def test_cand_fold_empty_block_skip():
    """All-empty blocks (no kept candidates, no valid uid rows — fully
    padded row blocks on padded meshes) are an exact no-op: sketch
    bit-unchanged, delta == edges == 0, mirroring update_block's dense
    zero-block lax.cond skip."""
    rng = np.random.default_rng(3)
    groups, nbins, block = 4, 128, 64
    empty = cm.CandBlock(
        jnp.full((2, block, nbins), -1, jnp.int8),
        jnp.full((block, 1), -1, jnp.int32),
        jnp.full((groups, nbins), -2, jnp.int32),
        jnp.int32(0))
    sketch = jnp.asarray(rng.normal(size=(16, groups * nbins))
                         .astype(np.float32))
    b, delta, edges = fd.shrink_rr_cands(sketch, empty, 16)
    np.testing.assert_array_equal(np.asarray(b), np.asarray(sketch))
    assert float(delta) == 0.0 and float(edges) == 0.0

    # and a NON-empty block still absorbs (the cond picks the right branch)
    cand = _random_cand(rng)
    sketch2 = jnp.asarray(rng.normal(size=(16, cand.uid_cols.shape[0]
                                           * cand.nbins))
                          .astype(np.float32))
    b2, _, edges2 = fd.shrink_rr_cands(sketch2, cand, 16)
    assert float(edges2) > 0.0
    assert not np.array_equal(np.asarray(b2), np.asarray(sketch2))
