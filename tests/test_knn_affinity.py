"""Per-modality kNN graphs (ops/affinity, ops/blocked_affinity) against a
NumPy oracle: float64 similarities, invalid and self columns excluded, the
k highest picked with ties going to the lowest column index.

Integer-valued features keep the device's f32 similarities exact, so ties
are real ties on both sides and the comparison is bit-for-bit."""
import numpy as np
import jax.numpy as jnp
import pytest

from mused_tpu.ops import affinity


def knn_oracle(sim, valid, k):
    """(n, n) 0/1 directed kNN adjacency, reference matrix_operations.py
    conventions: invalid rows emit and receive nothing, no self edges."""
    sim = np.array(sim, np.float64)
    n = sim.shape[0]
    sim[:, ~valid] = -np.inf
    np.fill_diagonal(sim, -np.inf)
    adj = np.zeros((n, n), np.float32)
    for i in np.flatnonzero(valid):
        order = np.argsort(-sim[i], kind="stable")[:min(k, n - 1)]
        order = order[np.isfinite(sim[i, order])]
        adj[i, order] = 1.0
    return adj


def haversine64(latlon):
    r = np.deg2rad(np.asarray(latlon, np.float64))
    dlat = r[:, 0][:, None] - r[:, 0][None, :]
    dlon = r[:, 1][:, None] - r[:, 1][None, :]
    h = (np.sin(dlat / 2) ** 2 + np.cos(r[:, 0])[:, None]
         * np.cos(r[:, 0])[None, :] * np.sin(dlon / 2) ** 2)
    return 2.0 * 6371.0 * np.arcsin(np.sqrt(np.clip(h, 0.0, 1.0)))


def jaccard64(m):
    m = np.asarray(m, np.float64)
    inter = m @ m.T
    s = m.sum(axis=1)
    union = s[:, None] + s[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def tfidf64(counts):
    c = np.asarray(counts, np.float64)
    valid = c.sum(axis=1) > 0
    n_docs = max(valid.sum(), 1.0)
    df = ((c > 0) & valid[:, None]).sum(axis=0)
    x = c * (np.log((1.0 + n_docs) / (1.0 + df)) + 1.0)[None, :]
    x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    return x @ x.T


def _case(metric, rng):
    """(device adjacency, oracle adjacency) for one metric."""
    n, kb = 96, 4
    if metric == "dot":
        x = rng.integers(-3, 4, (n, 12)).astype(np.float32)
        valid = rng.random(n) > 0.1
        sim = jnp.dot(jnp.asarray(x), jnp.asarray(x).T)
        got = affinity.knn_adjacency(sim, jnp.asarray(valid), kb)
        return got, knn_oracle(x.astype(np.float64) @ x.T, valid, kb)
    if metric == "euclidean":
        x = rng.integers(-5, 6, (n, 6)).astype(np.float32)
        x[rng.random(n) < 0.1] = np.nan
        valid = np.isfinite(x).all(axis=1)
        safe = np.where(valid[:, None], x, 0.0).astype(np.float64)
        d2 = ((safe[:, None, :] - safe[None, :, :]) ** 2).sum(-1)
        got = affinity.euclidean_adjacency(jnp.asarray(x), kb)
        return got, knn_oracle(-d2, valid, kb - 1)
    if metric == "time":
        t = rng.integers(1, 100_000, (n, 2)).astype(np.float32)
        t[rng.random(n) < 0.1, 0] = 0.0          # zero timestamp: invalid
        valid = (t != 0).all(axis=1)
        d = np.abs(t[:, None, :].astype(np.float64) - t[None, :, :]).sum(-1)
        got = affinity.time_adjacency(jnp.asarray(t), kb)
        return got, knn_oracle(-d, valid, 3 * kb)
    if metric == "location":
        latlon = rng.uniform([-80, -170], [80, 170], (n, 2)).astype(np.float32)
        latlon[rng.random(n) < 0.1] = np.nan
        valid = np.isfinite(latlon).all(axis=1)
        safe = np.where(valid[:, None], latlon, 0.0)
        got = affinity.location_adjacency(jnp.asarray(latlon), kb)
        return got, knn_oracle(-haversine64(safe), valid, kb)
    if metric == "tags":
        m = (rng.random((n, 64)) < 0.08).astype(np.float32)
        m[5] = 0.0                   # empty set: still a valid participant
        valid = np.ones(n, bool)
        valid[17] = False            # raw-cell-empty row
        got = affinity.tags_adjacency(jnp.asarray(m), kb, jnp.asarray(valid))
        return got, knn_oracle(jaccard64(m), valid, kb)
    if metric == "text":
        c = rng.poisson(0.3, (n, 64)).astype(np.float32)
        c[7] = 0.0                   # no tokens: invalid by default
        valid = c.sum(axis=1) > 0
        got = affinity.text_adjacency(jnp.asarray(c), kb)
        return got, knn_oracle(tfidf64(c), valid, kb)
    raise ValueError(metric)


@pytest.mark.parametrize("metric", ["dot", "euclidean", "time", "location",
                                    "tags", "text"])
def test_knn_matches_numpy_oracle(rng, metric):
    got, want = _case(metric, rng)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("metric", ["euclidean", "time", "location"])
def test_duplicate_features_emit_exactly_k(rng, metric):
    """40 rows sharing one geotag / timestamp pair / feature vector tie
    exactly; each valid row still gets exactly k edges, the lowest-index
    ones (lax.top_k's tie rule)."""
    n, kb = 64, 5
    if metric == "euclidean":
        x = rng.integers(-5, 6, (n, 6)).astype(np.float32)
        x[10:50] = x[10]
        got = affinity.euclidean_adjacency(jnp.asarray(x), kb + 1)
        d2 = ((x[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
        want = knn_oracle(-d2, np.ones(n, bool), kb)
    elif metric == "time":
        x = rng.integers(1, 10_000, (n, 2)).astype(np.float32)
        x[10:50] = x[10]
        got = affinity.time_adjacency(jnp.asarray(x), 2)
        kb = 6
        d = np.abs(x[:, None, :].astype(np.float64) - x[None]).sum(-1)
        want = knn_oracle(-d, np.ones(n, bool), kb)
    else:
        x = rng.uniform([-60, -150], [60, 150], (n, 2)).astype(np.float32)
        x[10:50] = x[10]
        got = affinity.location_adjacency(jnp.asarray(x), kb)
        want = knn_oracle(-haversine64(x), np.ones(n, bool), kb)
    got = np.asarray(got)
    assert (got.sum(axis=1) == kb).all()
    np.testing.assert_array_equal(got, want)


def test_fewer_valid_than_k(rng):
    n, kb = 40, 11
    x = rng.integers(-5, 6, (n, 8)).astype(np.float32)
    x[6:] = np.nan                    # only 6 valid rows: 5 neighbors each
    got = np.asarray(affinity.euclidean_adjacency(jnp.asarray(x), kb))
    valid = np.isfinite(x).all(axis=1)
    for i in range(n):
        assert got[i].sum() == (5 if valid[i] else 0)
    assert got[:, ~valid].sum() == 0


def test_time_nan_padded_rows(rng):
    """NaN-padded rows (the blocked/batch padding convention) and zero
    timestamps are invalid on the generic fusion path: no edges to or from
    them, everything else exactly the oracle's."""
    from mused_tpu.engine.streaming import _fuse_generic
    n = 64
    m = rng.integers(1, 10_000, (n, 2)).astype(np.float32)
    m[50:] = np.nan          # padding rows
    m[7] = 0.0               # reference zero-timestamp invalid row
    got = np.asarray(_fuse_generic((jnp.asarray(m),), k_basis=2,
                                   types=("time",)))
    valid = np.isfinite(m).all(axis=1) & (m != 0).all(axis=1)
    safe = np.where(valid[:, None], m, 0.0).astype(np.float64)
    d = np.abs(safe[:, None, :] - safe[None]).sum(-1)
    assert np.all(np.isfinite(got))
    assert got[50:].sum() == 0 and got[:, 50:].sum() == 0
    np.testing.assert_array_equal(got, knn_oracle(-d, valid, 6))


def test_chord3_city_scale_resolution():
    """At ~200 m spacing a unit-xyz DOT ranking saturates in f32; the
    blocked path's chord3 (explicit coordinate differences) keeps the
    haversine ranking, on the strip and the binned route alike."""
    from mused_tpu.ops import blocked_affinity as ba
    lat0, lon0, step = 41.39, 2.16, 0.0018          # Barcelona, ~200 m
    n, k = 128, 4
    latlon = np.array([[lat0 + i * step, lon0] for i in range(n)],
                      np.float32)
    cols = ba.generic_columns([latlon], ("location",))
    want = knn_oracle(-haversine64(latlon), np.ones(n, bool), k)
    for select, nbins in (("strip", 0), ("binned", n)):
        got = np.asarray(ba.fused_rowblock(cols, jnp.int32(0), n, k,
                                           select=select, nbins=nbins))
        np.testing.assert_array_equal(got, want)


def test_jaccard_duplicate_sets_large_n(rng):
    """Duplicate tag sets tie at Jaccard 1.0 by the hundred at n = 1024;
    exactly k edges per row, the lowest-index ones."""
    n, k = 1024, 3
    base = (rng.random((8, 64)) < 0.15).astype(np.float32)
    multihot = base[rng.integers(0, 8, size=n)]
    valid = np.ones(n, bool)
    got = np.asarray(affinity.tags_adjacency(jnp.asarray(multihot), k,
                                             jnp.asarray(valid)))
    assert (got.sum(axis=1) == k).all()
    np.testing.assert_array_equal(got, knn_oracle(jaccard64(multihot),
                                                  valid, k))
