"""Spectral clustering on the fused affinity graph.

Not in the reference's approach list but part of this framework's target
workloads (BASELINE.md config #2: crisis stream + spectral clustering) — and
a natural fit for the device: the whole algorithm is (normalize adjacency ->
eigh -> KMeans), i.e. exactly the dense-matrix ops the engine already runs.

Normalized-cuts formulation (Ng-Jordan-Weiss): rows of the top-k eigenvector
matrix of the symmetric-normalized affinity D^-1/2 (A + A^T)/2 D^-1/2,
row-normalized, clustered with KMeans.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import kmeans as kmeans_mod


def _normalized_spectrum(affinity: jax.Array):
    """(eigenvalues, eigenvectors) of D^-1/2 (A+A^T)/2 D^-1/2, descending."""
    a = (affinity + affinity.T) * 0.5
    a = a * (1.0 - jnp.eye(a.shape[0], dtype=a.dtype))   # no self loops
    deg = jnp.sum(a, axis=1)
    inv_sqrt = jnp.where(deg > 0, jax.lax.rsqrt(jnp.maximum(deg, 1e-12)), 0.0)
    norm = a * inv_sqrt[:, None] * inv_sqrt[None, :]
    # top eigenvectors of the normalized affinity == bottom of the Laplacian
    lam, vecs = jnp.linalg.eigh(norm)
    return lam[::-1], vecs[:, ::-1]


def _njw_embedding(vecs_desc: jax.Array, n_components,
                   max_components: int) -> jax.Array:
    """NJW tail: live-column mask + row normalization, static shape."""
    k_cap = min(max_components, vecs_desc.shape[1])
    emb = vecs_desc[:, :k_cap]
    alive = jnp.arange(k_cap)[None, :] < n_components
    emb = jnp.where(alive, emb, 0.0)
    # row-normalize (NJW step); zero rows stay zero
    nrm = jnp.linalg.norm(emb, axis=1, keepdims=True)
    emb = emb / jnp.maximum(nrm, 1e-12)
    if k_cap < max_components:
        emb = jnp.concatenate(
            [emb, jnp.zeros((emb.shape[0], max_components - k_cap), emb.dtype)],
            axis=1)
    return emb


def eigengap_k_from_spectrum(lam_desc: jax.Array, *, k_max: int,
                             k_min: int = 1,
                             floor: float = 1e-3,
                             rel_floor: float = 0.2) -> jax.Array:
    """Label-free cluster count from the normalized-affinity spectrum.

    For c well-separated clusters the normalized affinity has c eigenvalues
    near 1; in Laplacian terms the first c values of μ = 1 − λ are near 0
    and μ_{c+1} jumps.  The count is the largest RELATIVE jump μ_{i+1}/μ_i
    within the leading ``k_max`` — an absolute gap misfires because a kNN
    graph's spectrum keeps decaying smoothly past the cluster block and
    the biggest absolute drop often sits deep in that tail (measured: a
    planted-2-cluster window put λ₇−λ₈ = 0.38 against the true cluster gap
    λ₂−λ₃ = 0.18).

    The clamp on μ must be DATA-SCALED, not absolute: any connected graph
    has μ₁ = 0 exactly (the trivial eigenvalue), so with a tiny absolute
    floor the i=1 ratio μ₂/floor measures connectivity, not structure — on
    realistic noisy windows where within-cluster μ's are small-but-nonzero
    it reached ~120 and the estimate locked to k=1 (crisis stream: every
    window answered 1 against 5 planted events).  Clamping every μ at
    ``rel_floor`` × the spectrum's tail scale μ_m makes near-zero values —
    trivial OR structural — mutually ratio-1, so k=1 wins only when μ₂ is
    genuinely tail-sized (no nontrivial near-null direction).  Measured on
    crisis windows (5 events + noise class): noise 0.05/0.3 → k=5, 2
    events → 2, 12 events → 12, structureless all-noise window → 1.
    ``floor`` remains the absolute backstop for degenerate all-zero tails.
    The spectral counterpart of ops/reduction.eigengap_k (which works on
    singular-value energies of the reduced window)."""
    m = min(k_max + 1, lam_desc.shape[0])
    mu = 1.0 - lam_desc[:m]
    mu = jnp.maximum(mu, jnp.maximum(floor, rel_floor * mu[m - 1]))
    ratios = mu[1:] / mu[:-1]
    k = jnp.argmax(ratios) + 1
    return jnp.clip(k, k_min, k_max).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("max_components",))
def spectral_embedding(affinity: jax.Array, n_components: jax.Array,
                       *, max_components: int) -> jax.Array:
    """Spectral embedding with a DYNAMIC component count.

    Returns (n, max_components): the top eigenvectors of the normalized
    affinity in descending order, with columns >= n_components zeroed before
    the NJW row-normalization — so the geometry equals a k=n_components
    embedding while the shape stays static for jit.
    """
    _, vecs = _normalized_spectrum(affinity)
    return _njw_embedding(vecs, n_components, max_components)


@functools.partial(jax.jit, static_argnames=("k_max", "k_source",
                                             "background"))
def spectral_clustering(affinity: jax.Array, n_clusters: jax.Array,
                        key: jax.Array, *, k_max: int,
                        k_source: str = "given",
                        background: bool = False):
    """Labels (n,) from normalized-cuts spectral clustering of the affinity;
    n_clusters is dynamic (<= static k_max).

    ``k_source="eigengap"``: ignore ``n_clusters`` and estimate the count
    from the spectrum the embedding eigh already computes
    (eigengap_k_from_spectrum — the same rule the blocked/sharded huge-
    window spectral paths use), keeping the whole estimate in-graph.

    ``background=True``: re-label rows in the far mode of the embedding
    distance-to-centroid distribution -1 (kmeans.mark_background — the
    label-free background bucket; PipelineConfig.background_bucket)."""
    lam, vecs = _normalized_spectrum(affinity)
    if k_source == "eigengap":
        n_clusters = eigengap_k_from_spectrum(lam, k_max=k_max)
    emb = _njw_embedding(vecs, n_clusters, k_max)
    labels, _ = kmeans_mod.kmeans(emb, n_clusters, key, k_max=k_max)
    if background:
        labels = kmeans_mod.mark_background(emb, labels, k_max=k_max)
    return labels
