"""Per-modality directed kNN affinity graphs as batched XLA ops.

Reference behavior being reproduced (reference matrix_operations.py:14-132):
one dense n x n 0/1 adjacency per modality, edges i->j for j among i's k
nearest neighbors under a modality-specific similarity, self-edges skipped,
invalid rows (NaN coords, zero timestamps, empty strings) excluded entirely.

Device design: instead of sklearn NearestNeighbors / Python O(n^2) loops,
every modality becomes (masked dense similarity matrix) -> ``lax.top_k`` ->
scatter, i.e. matmuls + a vectorized select.  Validity is a mask, never a
dynamic shape.  Per-modality k conventions (SURVEY.md §2.4):

  location  k_basis   neighbors (ref :24 uses k_basis+1 incl. self)
  time      3*k_basis neighbors (ref :34 uses 3*k_basis+1 incl. self)
  username  ALL rows sharing the username (k ignored, ref :55-72)
  tags      k_basis   neighbors, self sim forced below any real sim (ref :88)
  text      k_basis   neighbors (ref :93 uses k_basis+1 incl. self)
  default   k_basis-1 neighbors (ref :113 k_basis incl. self)

Note the reference keeps zero-similarity "neighbors" (argsort takes exactly k
entries), so edges are NOT thresholded on similarity — only on column
validity.  That quirk is preserved.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NEG = -1e30  # "invalid" similarity sentinel; any real similarity is larger


def knn_adjacency(sim: jax.Array, valid: jax.Array, k: int,
                  exclude_self: bool = True) -> jax.Array:
    """Directed kNN adjacency from a similarity matrix (higher = closer).

    sim: (n, n) float32; valid: (n,) bool.  Invalid rows emit no edges and
    receive none.  Returns (n, n) float32 in {0, 1} with zero diagonal.
    """
    n = sim.shape[0]
    k = max(0, min(k, n - 1 if exclude_self else n))
    if k == 0:
        return jnp.zeros((n, n), jnp.float32)
    col_mask = valid[None, :]
    sim = jnp.where(col_mask, sim, NEG)
    if exclude_self:
        sim = jnp.where(jnp.eye(n, dtype=bool), NEG, sim)
    vals, idx = jax.lax.top_k(sim, k)                      # (n, k)
    edge = (vals > NEG / 2) & valid[:, None]               # drop invalid picks
    rows = jnp.broadcast_to(jnp.arange(n)[:, None], (n, k))
    adj = jnp.zeros((n, n), jnp.float32)
    # top_k indices are distinct within a row -> no write conflicts
    adj = adj.at[rows, idx].max(edge.astype(jnp.float32))
    return adj


# ---------------------------------------------------------------------------
# modality similarity kernels
# ---------------------------------------------------------------------------

def haversine_block(a: jax.Array, b: jax.Array) -> jax.Array:
    """Rectangular pairwise great-circle distance (km) between (m, 2) and
    (n, 2) [lat, lon] degree arrays.

    Vectorized form of the reference's per-pair callable metric (reference
    matrix_operations.py:250-263) — one fused elementwise expression instead of m*n
    Python calls.  Shared by the square, sharded, and blocked paths.
    """
    ra, rb = jnp.deg2rad(a), jnp.deg2rad(b)
    dlat = ra[:, 0][:, None] - rb[:, 0][None, :]
    dlon = ra[:, 1][:, None] - rb[:, 1][None, :]
    h = jnp.sin(dlat / 2) ** 2 + jnp.cos(ra[:, 0])[:, None] \
        * jnp.cos(rb[:, 0])[None, :] * jnp.sin(dlon / 2) ** 2
    return 2.0 * 6371.0 * jnp.arcsin(jnp.sqrt(jnp.clip(h, 0.0, 1.0)))


def haversine_matrix(latlon: jax.Array) -> jax.Array:
    """Square pairwise haversine distance (see haversine_block)."""
    return haversine_block(latlon, latlon)


def location_adjacency(latlon: jax.Array, k_basis: int) -> jax.Array:
    """kNN under haversine distance; NaN coordinates are invalid (ref :23-30)."""
    valid = jnp.all(jnp.isfinite(latlon), axis=1)
    safe = jnp.where(valid[:, None], latlon, 0.0)
    sim = -haversine_matrix(safe)
    return knn_adjacency(sim, valid, k_basis)


def time_adjacency(times: jax.Array, k_basis: int) -> jax.Array:
    """kNN under |dt_taken| + |dt_upload|; zero or non-finite timestamps
    invalid (ref :32-53; NaN also marks padding rows)."""
    valid = (jnp.all(jnp.isfinite(times), axis=1)
             & (times[:, 0] != 0.0) & (times[:, 1] != 0.0))
    taken = jnp.abs(times[:, 0][:, None] - times[:, 0][None, :])
    upload = jnp.abs(times[:, 1][:, None] - times[:, 1][None, :])
    sim = -(taken + upload)
    return knn_adjacency(sim, valid, 3 * k_basis)


def username_adjacency(user_ids: jax.Array) -> jax.Array:
    """Connect all rows sharing a username; k is ignored (ref :55-72).

    user_ids: (n,) int32 (host-hashed); negative = empty/invalid.
    """
    n = user_ids.shape[0]
    valid = user_ids >= 0
    same = (user_ids[:, None] == user_ids[None, :]) & valid[:, None] & valid[None, :]
    same = same & ~jnp.eye(n, dtype=bool)
    return same.astype(jnp.float32)


def jaccard_matrix(multihot: jax.Array) -> jax.Array:
    """Pairwise Jaccard over (n, H) 0/1 multi-hot tag incidence.

    intersection = M M^T (one matmul); union = |i| + |j| - intersection.
    Replaces the reference's O(n^2) Python set loop (ref :84-89).
    """
    m = multihot.astype(jnp.float32)
    inter = jnp.dot(m, m.T, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    sizes = jnp.sum(m, axis=1)
    union = sizes[:, None] + sizes[None, :] - inter
    return jnp.where(union > 0, inter / jnp.maximum(union, 1e-9), 0.0)


def tags_adjacency(tags_multihot: jax.Array, k_basis: int,
                   valid: jax.Array | None = None) -> jax.Array:
    """Top-k Jaccard neighbors (ref :74-89).

    The reference forces self-similarity to -1 (below every real Jaccard) and
    keeps zero-similarity picks; ``knn_adjacency`` reproduces both.  Validity
    quirk (ref :79): the reference only drops rows whose raw cell is the
    empty STRING — an empty tag LIST is a valid participant whose Jaccard is
    0 with everything, so it still emits k argsort-order edges.  Pass
    ``valid`` (from featurize_window's tags_valid) to reproduce that;
    without it, fall back to the all-zero-row heuristic.  (Tie ORDER within
    zero-similarity groups is quicksort-arbitrary in the reference; top_k's
    lowest-index-first is the closest deterministic match — measured better
    metric parity than pseudo-random spreading.)
    """
    tags_multihot = tags_multihot.astype(jnp.float32)
    if valid is None:
        valid = jnp.sum(tags_multihot, axis=1) > 0
    sim = jaccard_matrix(tags_multihot)
    return knn_adjacency(sim, valid, k_basis)


def tfidf_cosine_matrix(counts: jax.Array) -> jax.Array:
    """Pairwise cosine over sklearn-convention TF-IDF of hashed token counts.

    tf = raw count; idf = ln((1+n)/(1+df)) + 1 (smooth_idf, like the
    reference's TfidfVectorizer at ref :104-106); rows L2-normalized; cosine =
    one matmul.  n counts only valid (nonzero) documents, matching the
    reference fitting the vectorizer on valid rows only.
    """
    counts = counts.astype(jnp.float32)
    valid = jnp.sum(counts, axis=1) > 0
    n_docs = jnp.maximum(jnp.sum(valid.astype(jnp.float32)), 1.0)
    df = jnp.sum((counts > 0) & valid[:, None], axis=0).astype(jnp.float32)
    idf = jnp.log((1.0 + n_docs) / (1.0 + df)) + 1.0
    x = counts.astype(jnp.float32) * idf[None, :]
    norm = jnp.linalg.norm(x, axis=1, keepdims=True)
    x = x / jnp.maximum(norm, 1e-12)
    return jnp.dot(x, x.T, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


def text_adjacency(text_counts: jax.Array, k_basis: int,
                   valid: jax.Array | None = None) -> jax.Array:
    """Top-k TF-IDF-cosine neighbors (ref :91-110).

    Validity quirk (ref :97): the reference keeps every row where EITHER
    raw cell is a non-empty STRING — a row whose text yields no tokens
    (single-char words) still participates with an all-zero vector and
    receives k argsort-order zero-sim edges, exactly like the tags quirk.
    Pass ``valid`` computed from the raw cells to reproduce that
    (api.create_adjacency_matrix does); the default falls back to
    token-count validity (the engine's featurized-tensor convention)."""
    text_counts = text_counts.astype(jnp.float32)
    if valid is None:
        valid = jnp.sum(text_counts, axis=1) > 0
    sim = tfidf_cosine_matrix(text_counts)
    return knn_adjacency(sim, valid, k_basis)


def euclidean_adjacency(data: jax.Array, k_basis: int) -> jax.Array:
    """Default modality: Euclidean kNN, non-finite rows invalid (ref :112-119).

    The reference's NearestNeighbors(k_basis) includes each point as its own
    neighbor and then skips the self-edge, leaving k_basis-1 real edges.
    """
    valid = jnp.all(jnp.isfinite(data), axis=1)
    safe = jnp.where(valid[:, None], data, 0.0)
    sq = jnp.sum(safe * safe, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * jnp.dot(
        safe, safe.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)
    sim = -jnp.maximum(d2, 0.0)
    return knn_adjacency(sim, valid, max(1, k_basis) - 1)


def knn_adjacency_block(sim: jax.Array, row_valid: jax.Array,
                        col_valid: jax.Array, k: int,
                        row_offset, approx: bool = False,
                        out_dtype=jnp.float32) -> jax.Array:
    """Rectangular (m, n) kNN adjacency for a row block of a larger matrix.

    ``row_offset`` is the global index of local row 0 (for diagonal/self
    exclusion).  The building block of both the sharded multi-chip affinity
    (parallel/sharded.py) and the rematerialized blocked batch engine.

    ``approx=True`` selects ``lax.approx_max_k`` (a partial reduction with
    ~98.5% recall at the 0.95 target) — the huge-window regime's default,
    where exact TopK over n~100k columns is the per-block wall and a ~1.5%
    edge perturbation is far below the OR-fusion/sketch noise floor.  Exact
    on CPU (the fallback lowering).
    """
    m, n = sim.shape
    k = max(0, min(k, n - 1))
    if k == 0:
        return jnp.zeros((m, n), out_dtype)
    sim = jnp.where(col_valid[None, :], sim, NEG)
    global_row = row_offset + jnp.arange(m)
    is_self = global_row[:, None] == jnp.arange(n)[None, :]
    sim = jnp.where(is_self, NEG, sim)
    if approx:
        vals, idx = jax.lax.approx_max_k(sim, k, recall_target=0.95)
    else:
        vals, idx = jax.lax.top_k(sim, k)
    edge = (vals > NEG / 2) & row_valid[:, None]
    rows = jnp.broadcast_to(jnp.arange(m)[:, None], (m, k))
    # out_dtype=bool quarters the (m, n) adjacency traffic — the blocked
    # sweep ORs five of these per block and is HBM-bandwidth-bound
    adj = jnp.zeros((m, n), out_dtype)
    return adj.at[rows, idx].max(edge.astype(out_dtype))


def embedding_adjacency(emb: jax.Array, k_basis: int) -> jax.Array:
    """Dense-embedding modality (CLIP/BERT-style vectors): cosine kNN.

    Not in the reference (its modalities are raw social-media fields); this is
    the crisis-stream / high-dim-embedding workload of BASELINE.md configs
    #2/#4.  All-zero or non-finite rows are invalid.
    """
    finite = jnp.all(jnp.isfinite(emb), axis=1)
    safe = jnp.where(finite[:, None], emb, 0.0)
    norm = jnp.linalg.norm(safe, axis=1, keepdims=True)
    valid = finite & (norm[:, 0] > 0)
    x = safe / jnp.maximum(norm, 1e-12)
    sim = jnp.dot(x, x.T, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    return knn_adjacency(sim, valid, k_basis)


def counts_from_tokens(ids: jax.Array, counts: jax.Array | None,
                       dim: int) -> jax.Array:
    """Scatter sparse hashed tokens back to a dense (n, dim) f32 tensor.

    ids: (n, T) int32 with -1 padding; counts: (n, T) or None (multi-hot).
    The inverse of the sparse featurization (data/features.py) — runs on
    device so only the tiny (n, T) tensors cross the interconnect.
    """
    n, t = ids.shape
    valid = ids >= 0
    safe = jnp.where(valid, ids, 0).astype(jnp.int32)   # ids may arrive int16
    if counts is None:
        vals = valid.astype(jnp.float32)
    else:
        vals = jnp.where(valid, counts.astype(jnp.float32), 0.0)
    rows = jnp.broadcast_to(jnp.arange(n)[:, None], (n, t))
    # ids are deduped per row upstream -> no within-row collisions
    return jnp.zeros((n, dim), jnp.float32).at[rows, safe].add(vals)


def fuse(adjacency_matrices: list[jax.Array]) -> jax.Array:
    """Element-wise logical OR of modality graphs (ref matrix_operations.py:134-141)."""
    fused = adjacency_matrices[0]
    for m in adjacency_matrices[1:]:
        fused = jnp.maximum(fused, m)
    return fused


@functools.partial(jax.jit, static_argnames=("k_basis",))
def multimodal_fused_adjacency(location: jax.Array, times: jax.Array,
                               user_ids: jax.Array, tags_multihot: jax.Array,
                               text_counts: jax.Array, *, k_basis: int,
                               tags_valid: jax.Array | None = None) -> jax.Array:
    """All five modality graphs + OR-fusion in one jitted graph.

    XLA fuses the masking/scatter chains; the five similarity matrices are
    independent so the compiler is free to overlap their matmul work.
    """
    mats = [
        location_adjacency(location, k_basis),
        time_adjacency(times, k_basis),
        username_adjacency(user_ids),
        tags_adjacency(tags_multihot, k_basis, tags_valid),
        text_adjacency(text_counts, k_basis),
    ]
    return fuse(mats)
