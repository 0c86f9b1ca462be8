"""Blocked spectral clustering: normalized-cuts beyond the dense cap.

The dense path (ops/spectral.py) eigendecomposes the (n, n) normalized
affinity.  Here the matrix stays implicit: with A the fused adjacency
(rematerialized row blocks, ops/blocked_affinity) and
``M = D^{-1/2} (A + A^T)/2 D^{-1/2}``, the top eigenvectors come from
subspace iteration whose M-products are blocked sweeps:

  degrees:   one sweep accumulating row sums of A and A^T
  M @ V:     two sweeps per iteration (A u and A^T u for u = D^{-1/2} V)
  Ritz step: small (k+p)^2 eigh on the host-side projected matrix

then the NJW row-normalization and device KMeans exactly as the dense path.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from mused_tpu.ops import blocked_affinity as ba
from mused_tpu.ops import kmeans as kmeans_mod
# canonical def lives with the dense spectral ops; re-exported here because
# the blocked/sharded paths feed it Ritz values
from mused_tpu.ops.spectral import eigengap_k_from_spectrum  # noqa: F401

HIGH = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("kinds", "block", "k_basis",
                                              "approx_knn", "select",
                                              "nbins"))
def _degrees(tensors, valids, idf, *, kinds, block: int, k_basis: int,
             approx_knn: bool = False, select: str = "strip",
             nbins: int = 0):
    cols = ba.Columns(kinds=kinds, tensors=tensors, valids=valids, idf=idf)
    n = cols.n

    def f(carry, fused, start):
        row_sums, col_sums = carry
        row_sums = jax.lax.dynamic_update_slice_in_dim(
            row_sums, jnp.sum(fused, axis=1), start, axis=0)
        return row_sums, col_sums + jnp.sum(fused, axis=0)

    row_sums, col_sums = ba._scan_blocks(
        cols, block, k_basis, f, (jnp.zeros(n), jnp.zeros(n)),
        approx=approx_knn, select=select, nbins=nbins)
    return 0.5 * (row_sums + col_sums)


@functools.partial(jax.jit, static_argnames=("kinds", "block", "k_basis",
                                              "approx_knn", "select",
                                              "nbins"))
def _sym_matmul(tensors, valids, idf, v, *, kinds, block: int, k_basis: int,
                approx_knn: bool = False, select: str = "strip",
                nbins: int = 0):
    """((A + A^T)/2) @ v via two accumulating block sweeps; v is (n, m)."""
    cols = ba.Columns(kinds=kinds, tensors=tensors, valids=valids, idf=idf)
    n = cols.n

    def f(carry, fused, start):
        av, atv = carry
        vb = jax.lax.dynamic_slice_in_dim(v, start, fused.shape[0], axis=0)
        av = jax.lax.dynamic_update_slice_in_dim(
            av, jnp.dot(fused, v, precision=HIGH), start, axis=0)
        return av, atv + jnp.dot(fused.T, vb, precision=HIGH)

    av, atv = ba._scan_blocks(cols, block, k_basis, f,
                              (jnp.zeros_like(v), jnp.zeros_like(v)),
                              approx=approx_knn, select=select, nbins=nbins)
    return 0.5 * (av + atv)


def ritz_from_products(sym_matmul, inv_sqrt: jax.Array, key: jax.Array, *,
                       n: int, m: int, n_iter: int = 6):
    """Subspace iteration + Rayleigh-Ritz for M = D^{-1/2} Â D^{-1/2} given
    only ``sym_matmul(v) = Â @ v`` and the degree scaling — the ONE copy of
    the spectral-embedding recipe shared by the single-chip blocked path
    and the sharded layouts (parallel/sharded, parallel/colsharded).
    Returns (ritz (n, m) basis, eigenvalue estimates (m,)), both in
    descending eigenvalue order — the eigenvalues feed the label-free
    cluster-count estimate (eigengap_k_from_spectrum)."""
    v = jax.random.normal(key, (n, m), jnp.float32)
    for _ in range(n_iter):
        mv = sym_matmul(v * inv_sqrt[:, None]) * inv_sqrt[:, None]
        v, _ = jnp.linalg.qr(mv)
    mv = sym_matmul(v * inv_sqrt[:, None]) * inv_sqrt[:, None]
    t = jnp.dot(v.T, mv, precision=HIGH)
    lam, w = jnp.linalg.eigh(0.5 * (t + t.T))
    return jnp.dot(v, w[:, ::-1], precision=HIGH), lam[::-1]


def spectral_embedding_blocked(cols: ba.Columns, key: jax.Array, *,
                               k_max: int, block: int, k_basis: int,
                               n_iter: int = 6, oversample: int = 8,
                               approx_knn: bool = False,
                               select: str = "strip", nbins: int = 0):
    """(ritz, eigenvalues) of the implicit fused adjacency's normalized-cuts
    operator — the embedding half of spectral_clustering_blocked, exposed
    so the engine can estimate the cluster count from the spectrum before
    committing to labels (k_estimate="eigengap").

    ``select``/``nbins`` route the sweeps' kNN through stride-binned
    candidate selection exactly as blocked_fd_sketch / blocked_svd_reduce
    do — the engine resolves them once per window, so a 1-chip sSpectral
    run builds the SAME adjacency as the sharded layouts."""
    n = cols.n
    assert n % block == 0, "pad rows to a block multiple upstream"
    kinds = cols.kinds
    deg = _degrees(cols.tensors, cols.valids, cols.idf, kinds=kinds,
                   block=block, k_basis=k_basis, approx_knn=approx_knn,
                   select=select, nbins=nbins)
    inv_sqrt = jnp.where(deg > 0, jax.lax.rsqrt(jnp.maximum(deg, 1e-12)), 0.0)
    m = min(k_max + oversample, n)

    def sym(v):
        return _sym_matmul(cols.tensors, cols.valids, cols.idf, v,
                           kinds=kinds, block=block, k_basis=k_basis,
                           approx_knn=approx_knn, select=select, nbins=nbins)

    return ritz_from_products(sym, inv_sqrt, key, n=n, m=m, n_iter=n_iter)


def spectral_clustering_blocked(cols: ba.Columns, n_clusters: int,
                                key: jax.Array, *, k_max: int, block: int,
                                k_basis: int, n_real: int | None = None,
                                n_iter: int = 6, oversample: int = 8,
                                approx_knn: bool = False,
                                select: str = "strip", nbins: int = 0):
    """Labels (n_real,) — blocked normalized-cuts spectral clustering.

    ``cols`` from blocked_affinity.standard_columns / generic_columns with
    rows padded to a block multiple (padding rows are invalid => zero degree
    and zero embedding); ``n_real`` slices them off before KMeans so the
    origin-blob of padding rows cannot steal a centroid.
    """
    n_real = cols.n if n_real is None else n_real
    # the accumulating sweeps (degrees, A^T v) would double-count the rows of
    # a clamped final block — spectral_embedding_blocked asserts exact tiling
    ritz, _ = spectral_embedding_blocked(
        cols, key, k_max=k_max, block=block, k_basis=k_basis, n_iter=n_iter,
        oversample=oversample, approx_knn=approx_knn, select=select,
        nbins=nbins)
    return labels_from_ritz(ritz, n_clusters, key, k_max=k_max,
                            n_real=n_real)


def labels_from_ritz(ritz: jax.Array, n_clusters, key: jax.Array, *,
                     k_max: int, n_real: int, background: bool = False):
    """NJW tail shared with the sharded spectral paths (parallel/sharded,
    parallel/colsharded): slice the live eigenvectors, row-normalize, KMeans
    — identical to the dense path's final step.  ``background=True`` applies
    the label-free background bucket on the same embedding (kmeans.
    mark_background — the dense path's spectral_clustering counterpart)."""
    emb = ritz[:n_real, :k_max]
    alive = jnp.arange(emb.shape[1])[None, :] < n_clusters
    emb = jnp.where(alive, emb, 0.0)
    nrm = jnp.linalg.norm(emb, axis=1, keepdims=True)
    emb = emb / jnp.maximum(nrm, 1e-12)
    labels, _ = kmeans_mod.kmeans(emb, jnp.int32(n_clusters), key, k_max=k_max)
    if background:
        labels = kmeans_mod.mark_background(emb, labels, k_max=k_max)
    return labels
