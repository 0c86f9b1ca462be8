"""Stride-binned candidate selection (ops/binned_select): candidates must
match a residue-bin NumPy oracle, and candidates->top-k must reproduce exact
kNN when nbins == n."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mused_tpu.ops import binned_select as bs
from mused_tpu.ops import affinity


def _strip_sim(x, start, block, metric, sums=None):
    xr = x[start:start + block]
    if metric == "dot":
        return jnp.dot(xr.astype(jnp.float32), x.astype(jnp.float32).T)
    if metric == "jaccard":
        inter = jnp.dot(xr.astype(jnp.float32), x.astype(jnp.float32).T)
        s = np.asarray(sums, np.float32)
        union = s[start:start + block, None] + s[None, :] - inter
        return jnp.where(union > 0, inter / jnp.maximum(union, 1e-9), 0.0)
    raise ValueError(metric)


def _oracle_candidates(sim, valid, start, nbins):
    """NumPy residue-bin oracle: column c lives in slot c % nbins of group
    c // nbins; invalid and self columns rank at NEG; the lowest group wins
    ties."""
    sim = np.array(sim, np.float64)
    block, n = sim.shape
    cols = np.arange(n)
    for r in range(block):
        sim[r, ~valid] = bs.NEG
        sim[r, cols == start + r] = bs.NEG
    s = sim.reshape(block, n // nbins, nbins)
    return s.max(axis=1), s.argmax(axis=1)


@pytest.mark.parametrize("metric", ["dot", "jaccard"])
@pytest.mark.parametrize("nbins", [128, 256, 512])
def test_binned_candidates_match_numpy_oracle(metric, nbins):
    rng = np.random.default_rng(0)
    n, block, start = 512, 128, 256
    if metric == "jaccard":
        x = (rng.random((n, 256)) < 0.05).astype(np.float32)
        sums = x.sum(axis=1)
    else:
        x = rng.standard_normal((n, 256)).astype(np.float32)
        x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        sums = None
    valid = rng.random(n) > 0.1
    sim = np.asarray(_strip_sim(jnp.asarray(x), start, block, metric, sums))
    vals, grp = bs.binned_candidates_reference(
        jnp.asarray(sim), jnp.asarray(valid), start, nbins)
    want_v, want_g = _oracle_candidates(sim, valid, start, nbins)
    np.testing.assert_allclose(np.asarray(vals), want_v, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(grp), want_g)


@pytest.mark.parametrize("kind", ["location_xyz", "time"])
def test_binned_loc_time_match_numpy_oracle(kind):
    """The chord3 (location) and l1 (time) binned routes of
    blocked_affinity: candidates from the strip their sim_fn builds must
    equal the residue-bin oracle on NumPy's own distances."""
    from mused_tpu.ops import blocked_affinity as ba
    rng = np.random.default_rng(1)
    n, block, start, nbins, k = 512, 128, 128, 128, 4
    if kind == "location_xyz":
        x = rng.standard_normal((n, 3)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        d = ((x[start:start + block, None, :].astype(np.float64)
              - x[None, :, :]) ** 2).sum(-1)
    else:
        x = rng.uniform(1.0, 1e5, size=(n, 2)).astype(np.float32)
        d = np.abs(x[start:start + block, None, :].astype(np.float64)
                   - x[None, :, :]).sum(-1)
    valid = rng.random(n) > 0.1
    spec = ba._kind_cand_spec(kind, jnp.asarray(x), jnp.asarray(valid), k,
                              jnp.int32(start), block, n)
    vals, grp = bs.binned_candidates_reference(
        spec["sim_fn"](), jnp.asarray(valid), start, nbins)
    want_v, want_g = _oracle_candidates(-d, valid, start, nbins)
    np.testing.assert_allclose(np.asarray(vals), want_v, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(grp), want_g)


def test_exact_when_nbins_equals_n():
    """nbins == n puts every column in its own bin: candidates + exact
    top-k must equal affinity.knn_adjacency_block (exact path)."""
    rng = np.random.default_rng(1)
    n, block, start, k = 256, 64, 64, 5
    x = rng.standard_normal((n, 128)).astype(np.float32)
    valid = rng.random(n) > 0.2
    row_valid = valid[start:start + block]
    xin = jnp.asarray(x)

    sim = jnp.dot(xin[start:start + block], xin.T)
    vals, grp = bs.binned_candidates_reference(
        sim, jnp.asarray(valid), start, nbins=n)
    keep = bs.budgeted_keep(vals, jnp.asarray(row_valid), k)
    adj = bs.adjacency_from_candidates([keep], [grp], n)

    want = affinity.knn_adjacency_block(
        sim, jnp.asarray(row_valid), jnp.asarray(valid), k,
        jnp.int32(start), False, out_dtype=jnp.bool_)
    np.testing.assert_array_equal(np.asarray(adj), np.asarray(want))


def test_ties_prefer_lowest_group():
    """Duplicate columns (exact sim ties across groups) must keep the
    lowest column index, matching lax.top_k order."""
    n, block, nbins = 256, 64, 128
    x = np.zeros((n, 128), np.float32)
    x[:, 0] = 1.0                      # every pair ties at sim 1.0
    sim = jnp.asarray(x[:block] @ x.T)
    _, grp = bs.binned_candidates_reference(sim, jnp.ones(n, bool),
                                            jnp.int32(0), nbins)
    grp = np.asarray(grp)
    # slot s of row r: candidates are cols {s, s+128}; the self col is
    # excluded, otherwise the LOWER index (group 0) must win the tie
    for r in (0, 5, 63):
        for s in (0, 3, 127):
            want = 1 if s == r else 0
            assert grp[r, s] == want, (r, s, grp[r, s])


def _standard_cols():
    from mused_tpu.data.synthetic import synthetic_events_dataframe
    from mused_tpu.data.sed2012 import prepare_modalities
    from mused_tpu.data import features as feat
    from mused_tpu.ops import blocked_affinity as ba
    from mused_tpu.utils.config import FeatureConfig
    df = synthetic_events_dataframe(n_rows=300, n_events=4, noise_rate=0.5,
                                    seed=0)
    mods, _, _ = prepare_modalities(df, subset_size=256, binary=True,
                                    sort_by_uploaded=False, noise_rate=0.5,
                                    seed=0)
    fc = FeatureConfig()
    wf = feat.featurize_window(*mods, fc)
    return ba.standard_columns(wf, fc)


def test_fused_rowblock_binned_exact_at_nbins_n():
    """select="binned" with nbins == n is exact top-k: the fused adjacency
    must equal the strip path (approx=False) bit-for-bit — exercises the
    scatter union, the jaccard emulator with hoisted sums, and the bf16
    text/tags columns."""
    from mused_tpu.ops import blocked_affinity as ba
    cols = _standard_cols()
    n, block = cols.n, 64
    for start in (0, 64, 192):
        strip = ba.fused_rowblock(cols, jnp.int32(start), block, 5,
                                  approx=False)
        binned = ba.fused_rowblock(cols, jnp.int32(start), block, 5,
                                   approx=False, select="binned", nbins=n)
        np.testing.assert_array_equal(np.asarray(strip), np.asarray(binned))


def test_blocked_fd_sketch_binned_quality():
    """At a real reduction (nbins = n/2) the binned sketch must stay close
    to the exact strip sketch (spectral structure, not bitwise)."""
    from mused_tpu.ops import blocked_affinity as ba
    cols = _standard_cols()
    n = cols.n
    sk_s, sq_s, _ = ba.blocked_fd_sketch(cols, ell=16, block=64, k_basis=5,
                                         mode="eigh")
    sk_b, sq_b, _ = ba.blocked_fd_sketch(cols, ell=16, block=64, k_basis=5,
                                         mode="eigh", select="binned",
                                         nbins=n // 2)
    # total adjacency mass within 10% and top singular directions aligned
    assert abs(float(sq_b) - float(sq_s)) / max(float(sq_s), 1.0) < 0.1
    gs = np.asarray(sk_s).T @ np.asarray(sk_s)
    gb = np.asarray(sk_b).T @ np.asarray(sk_b)
    num = np.linalg.norm(gs - gb)
    assert num / max(np.linalg.norm(gs), 1e-9) < 0.35


def test_fused_rowblock_generic_kinds_binned_exact():
    """embedding/default kinds: select="binned" at nbins == n must bit-equal
    the strip path — both rank by the SAME split-packed bf16 sims, so there
    is no select-mode precision cliff (the binned route previously dropped
    the strip path's f32 dot; round-2 review finding)."""
    from mused_tpu.ops import blocked_affinity as ba
    rng = np.random.default_rng(3)
    n = 256
    emb = rng.standard_normal((n, 96)).astype(np.float32)
    emb[rng.random(n) < 0.05] = np.nan
    dflt = (rng.standard_normal((n, 24)) * 3).astype(np.float32)
    dflt[rng.random(n) < 0.05] = np.nan
    cols = ba.generic_columns([emb, dflt], ("embedding", "default"))
    assert cols.kinds == ("embedding_bf16", "default_safe")
    assert cols.tensors[0].dtype == jnp.bfloat16
    assert cols.tensors[1][0].dtype == jnp.bfloat16
    for start in (0, 128):
        strip = ba.fused_rowblock(cols, jnp.int32(start), 64, 5)
        binned = ba.fused_rowblock(cols, jnp.int32(start), 64, 5,
                                   select="binned", nbins=n)
        np.testing.assert_array_equal(np.asarray(strip), np.asarray(binned))


def test_bf16_packing_matches_exact_f32_ranking():
    """The single-bf16 representation (round 5 — replaced the 2x-width
    split packing, whose positional dot has the same bf16-input accuracy
    class) rounds inputs to 8 mantissa bits (~4e-3 relative) — kNN edges
    vs the exact-f32 legacy layout must agree almost everywhere on unit
    embeddings, and the represented values must be within bf16 rounding.
    split_bf16 itself (the legacy layout, still supported for hand-built
    Columns) must reconstruct to ~16-bit rounding."""
    from mused_tpu.ops import blocked_affinity as ba
    rng = np.random.default_rng(4)
    n, d, k = 512, 128, 5
    emb = rng.standard_normal((n, d)).astype(np.float32)
    unit = emb / np.linalg.norm(emb, axis=1, keepdims=True)

    packed = np.asarray(ba.bf16_pack(jnp.asarray(unit)))
    assert packed.shape[1] == d and packed.dtype == jnp.bfloat16
    np.testing.assert_allclose(packed.astype(np.float32), unit, atol=4e-3)

    split = np.asarray(ba.split_bf16(jnp.asarray(unit)))
    recon = split[:, :d].astype(np.float32) + split[:, d:].astype(np.float32)
    np.testing.assert_allclose(recon, unit, atol=4e-5)

    cols_split = ba.generic_columns([emb], ("embedding",))
    valid = jnp.ones(n, bool)
    cols_f32 = ba.Columns(kinds=("embedding_unit",),
                          tensors=(jnp.asarray(unit),),
                          valids=(valid,), idf=None)
    a_split = np.concatenate([np.asarray(ba.fused_rowblock(
        cols_split, jnp.int32(s), 128, k)) for s in range(0, n, 128)])
    a_f32 = np.concatenate([np.asarray(ba.fused_rowblock(
        cols_f32, jnp.int32(s), 128, k)) for s in range(0, n, 128)])
    agree = (a_split > 0) & (a_f32 > 0)
    union = (a_split > 0) | (a_f32 > 0)
    assert agree.sum() / union.sum() >= 0.99, (agree.sum(), union.sum())


@pytest.mark.slow
def test_spectral_blocked_select_consistency():
    """spectral_embedding_blocked now honors select/nbins: at nbins == n the
    binned sweeps are exact, so labels must equal the strip path's exactly —
    and a 1-chip sSpectral run builds the same adjacency as the sharded
    layouts (round-2 review finding: the plumbing was missing)."""
    import jax as _jax
    from mused_tpu.ops import blocked_affinity as ba
    from mused_tpu.ops.blocked_spectral import spectral_clustering_blocked
    rng = np.random.default_rng(5)
    n, c = 256, 3
    centers = rng.normal(size=(c, 16)).astype(np.float32) * 8
    x = np.concatenate([centers[i] + rng.normal(
        size=(n // c + 1, 16)).astype(np.float32) * 0.2
        for i in range(c)])[:n]
    cols = ba.generic_columns([x], ("default",))
    strip = np.asarray(spectral_clustering_blocked(
        cols, c, _jax.random.key(2), k_max=c, block=64, k_basis=6))
    binned = np.asarray(spectral_clustering_blocked(
        cols, c, _jax.random.key(2), k_max=c, block=64, k_basis=6,
        select="binned", nbins=n))
    np.testing.assert_array_equal(strip, binned)


def test_default_nbins():
    assert bs.default_nbins(98304) == 1536
    assert bs.default_nbins(98304, k_max=150) == 1536
    assert bs.default_nbins(32768, k_max=150) == 2048   # 8*k floor bumps
    n = 2048
    nb = bs.default_nbins(n)
    assert nb % 128 == 0 and n % nb == 0
    assert bs.default_nbins(1000) == 0          # not tn-divisible


def test_jaccard_int8_bitexact_vs_f32():
    """int8 tag counts through the binned jaccard route produce
    BIT-IDENTICAL candidates to f32 counts: the intersection is the same
    integer (int8 exact up to the token cap), the union arithmetic is f32
    both ways."""
    from mused_tpu.ops import blocked_affinity as ba
    rng = np.random.default_rng(2)
    n, block, start, nbins, k = 512, 128, 0, 128, 5
    x = rng.poisson(0.08, size=(n, 256)).astype(np.float32)
    sums = jnp.asarray(x.sum(axis=1))
    valid = jnp.asarray(rng.random(n) > 0.1)
    out = []
    for t in (jnp.asarray(x).astype(jnp.int8), jnp.asarray(x)):
        spec = ba._kind_cand_spec("tags", t, valid, k, jnp.int32(start),
                                  block, n, sums)
        out.append(ba._modality_candidates(
            valid=valid, vr=valid[start:start + block], start=start,
            block=block, n=n, nbins=nbins, **spec))
    (k8, g8), (kf, gf) = out
    np.testing.assert_array_equal(np.asarray(k8), np.asarray(kf))
    np.testing.assert_array_equal(np.asarray(g8), np.asarray(gf))
