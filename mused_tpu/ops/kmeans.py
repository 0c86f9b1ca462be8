"""Device KMeans family: jitted kmeans++ / Lloyd, and MiniBatchKMeans state.

Replaces sklearn KMeans / MiniBatchKMeans (reference matrix_operations.py:
149-153; main.py:82-85).  Device-first choices:

  * the number of clusters is DYNAMIC per window in the reference (it uses
    the window's unique ground-truth label count, reference main.py:41,97 — a
    quirk preserved for comparability, SURVEY.md §2.4).  A dynamic k would
    recompile per window, so centroids are padded to a static ``k_max`` and
    dead centers are masked to +inf distance;
  * assignment distances and centroid accumulation are one-hot matmuls,
    not gathers;
  * Lloyd runs under ``lax.while_loop`` with a center-shift tolerance.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

INF = jnp.inf


def _sq_dists(x: jax.Array, centroids: jax.Array) -> jax.Array:
    """(n, k) squared Euclidean distances via the expanded-norm matmul form."""
    xn = jnp.sum(x * x, axis=1)
    cn = jnp.sum(centroids * centroids, axis=1)
    cross = jnp.dot(x, centroids.T, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(xn[:, None] + cn[None, :] - 2.0 * cross, 0.0)


def _kmeanspp_init(x: jax.Array, k_max: int, k: jax.Array, key: jax.Array) -> jax.Array:
    """kmeans++ seeding, scanned over k_max steps (steps >= k are masked)."""
    n, d = x.shape
    first = jax.random.randint(key, (), 0, n)
    c0 = x[first]
    min_d2 = _sq_dists(x, c0[None, :])[:, 0]

    def step(carry, inp):
        min_d2, = carry
        j, kj = inp
        probs = jnp.where(jnp.sum(min_d2) > 0, min_d2 / jnp.sum(min_d2),
                          jnp.ones_like(min_d2) / n)
        idx = jax.random.choice(kj, n, p=probs)
        c = x[idx]
        new_min = jnp.minimum(min_d2, jnp.sum((x - c[None, :]) ** 2, axis=1))
        use = j < k
        min_d2 = jnp.where(use, new_min, min_d2)
        return (min_d2,), jnp.where(use, c, jnp.zeros_like(c))

    keys = jax.random.split(key, k_max - 1)
    (_,), rest = jax.lax.scan(step, (min_d2,), (jnp.arange(1, k_max), keys))
    return jnp.concatenate([c0[None, :], rest], axis=0)


@functools.partial(jax.jit, static_argnames=("k_max", "max_iters"))
def kmeans(x: jax.Array, k: jax.Array, key: jax.Array, *, k_max: int,
           max_iters: int = 100, tol: float = 1e-4):
    """Lloyd KMeans on (n, d) points with dynamic cluster count ``k <= k_max``.

    Returns (labels (n,) int32 in [0, k), centroids (k_max, d)).
    """
    n, d = x.shape
    x = x.astype(jnp.float32)
    k = jnp.asarray(k, jnp.int32)
    alive = jnp.arange(k_max) < k                      # static-shape center mask
    centroids = _kmeanspp_init(x, k_max, k, key)

    def assign(c):
        dist = _sq_dists(x, c)
        dist = jnp.where(alive[None, :], dist, INF)
        return jnp.argmin(dist, axis=1)

    def body(state):
        c, _, it = state
        labels = assign(c)
        onehot = (labels[:, None] == jnp.arange(k_max)[None, :]).astype(jnp.float32)
        counts = jnp.sum(onehot, axis=0)
        sums = jnp.dot(onehot.T, x, preferred_element_type=jnp.float32)
        new_c = jnp.where((counts > 0)[:, None], sums / jnp.maximum(counts, 1.0)[:, None], c)
        # empty-cluster relocation (sklearn semantics): the i-th empty live
        # cluster moves to the i-th worst-fit point.  Gated on any-empty so
        # the common case skips the extra distance pass (cond on a scalar
        # inside while_loop stays a real branch).
        empty = alive & (counts == 0)

        def relocate(nc):
            dist_to_own = jnp.take_along_axis(
                _sq_dists(x, nc), labels[:, None], axis=1)[:, 0]
            k_eff = min(k_max, n)
            _, far_idx = jax.lax.top_k(dist_to_own, k_eff)
            slot = jnp.cumsum(empty.astype(jnp.int32)) - 1    # i-th empty -> i
            reloc = x[far_idx[jnp.clip(slot, 0, k_eff - 1)]]
            return jnp.where(empty[:, None], reloc, nc)

        new_c = jax.lax.cond(jnp.any(empty), relocate, lambda nc: nc, new_c)
        shift = jnp.sum((new_c - c) ** 2)
        return new_c, shift, it + 1

    def cond(state):
        _, shift, it = state
        return (shift > tol) & (it < max_iters)

    centroids, _, _ = jax.lax.while_loop(cond, body, (centroids, jnp.asarray(INF), 0))
    return assign(centroids), centroids


class MiniBatchState(NamedTuple):
    """Streaming MiniBatchKMeans state persisted across windows
    (the ``clusterer`` kept alive in reference main.py:82-85)."""

    centroids: jax.Array   # (k, d)
    counts: jax.Array      # (k,) float32 — cumulative per-center mass
    initialized: jax.Array  # () bool


def minibatch_init(k: int, d: int) -> MiniBatchState:
    return MiniBatchState(
        centroids=jnp.zeros((k, d), jnp.float32),
        counts=jnp.zeros((k,), jnp.float32),
        initialized=jnp.zeros((), bool),
    )


@jax.jit
def minibatch_step(state: MiniBatchState, x: jax.Array, key: jax.Array):
    """partial_fit + predict on one window (sklearn-style streaming update:
    per-center learning rate 1/count).  Returns (new_state, labels)."""
    k, d = state.centroids.shape

    def do_init(_):
        return _kmeanspp_init(x.astype(jnp.float32), k, jnp.asarray(k, jnp.int32), key)

    centroids = jax.lax.cond(state.initialized, lambda _: state.centroids,
                             do_init, None)
    dist = _sq_dists(x.astype(jnp.float32), centroids)
    labels = jnp.argmin(dist, axis=1).astype(jnp.int32)
    onehot = (labels[:, None] == jnp.arange(k)[None, :]).astype(jnp.float32)
    batch_counts = jnp.sum(onehot, axis=0)
    batch_sums = jnp.dot(onehot.T, x.astype(jnp.float32),
                         preferred_element_type=jnp.float32)
    new_counts = state.counts + batch_counts
    eta = jnp.where(new_counts > 0, batch_counts / jnp.maximum(new_counts, 1.0), 0.0)
    batch_mean = batch_sums / jnp.maximum(batch_counts, 1.0)[:, None]
    new_centroids = centroids * (1.0 - eta[:, None]) + batch_mean * eta[:, None]
    new_state = MiniBatchState(new_centroids, new_counts, jnp.ones((), bool))
    # labels re-predicted against the updated centers (sklearn .partial_fit().predict())
    dist2 = _sq_dists(x.astype(jnp.float32), new_centroids)
    return new_state, jnp.argmin(dist2, axis=1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k_max",))
def mark_background(x: jax.Array, labels: jax.Array, *, k_max: int,
                    min_frac: float = 0.02, max_frac: float = 0.5,
                    sep: float = 2.0, min_far: float = 0.3) -> jax.Array:
    """Label-free background/outlier bucket over a clustering's residuals.

    No reference analog (the reference forces every row into a cluster).
    Production streams carry rows that belong to NO event — scattered
    background chatter the affinity graph wires weakly into whichever
    community is nearest.  Those rows are invisible to the (correct)
    eigengap community count but visible in embedding geometry: on the
    row-normalized sphere their angular distance to the assigned
    cluster's direction sits in a separate far mode (measured AUC 0.98
    vs ground-truth noise rows on crisis windows; real background sits
    at chordal distance ~0.6 where clean clusters' tails stay under
    ~0.1).  This helper re-labels that far mode -1:

      * rows are unit-normalized and per-cluster member means recomputed
        (at Lloyd convergence these ARE the kmeans centroids; for
        non-normalized inputs this makes the score a pure angular
        residual, scale-free by construction);
      * Otsu split of the per-row distance distribution (the split
        maximizing between-mode variance — sort + cumsum, in-graph);
      * accepted only when the far mode is REAL:
        mean(far) >= ``sep`` x mean(near)  (bimodality),
        mean(far) >= ``min_far``           (an absolute angular floor —
        chord 0.3 ~ 17 deg; clean windows' Otsu "far" tail measures
        0.07-0.10 and is rejected, real background 0.6),
        far fraction in [min_frac, max_frac]  (majority-noise windows
        fail max_frac: flagging half the window would hide an unreliable
        clustering rather than report it).

    Composes with matching: the engine's matchers pass -1 through
    unchanged, so the background id is globally stable by construction.
    """
    n = x.shape[0]
    if n < 2:            # nothing to split (and argmax over the empty
        return labels.astype(jnp.int32)   # split scores would not trace)
    xf = x.astype(jnp.float32)
    xn = xf / jnp.maximum(jnp.linalg.norm(xf, axis=1, keepdims=True), 1e-12)
    onehot = (labels[:, None] == jnp.arange(k_max)[None, :]).astype(
        jnp.float32)
    sums = jnp.dot(onehot.T, xn, preferred_element_type=jnp.float32)
    counts = jnp.sum(onehot, axis=0)
    cents = sums / jnp.maximum(counts, 1.0)[:, None]
    diff = xn - cents[labels]
    dist = jnp.sqrt(jnp.sum(diff * diff, axis=1))
    ds = jnp.sort(dist)
    csum = jnp.cumsum(ds)
    total = csum[-1]
    idx = jnp.arange(1, n, dtype=jnp.float32)       # split after idx rows
    m0 = csum[:-1] / idx
    m1 = (total - csum[:-1]) / (n - idx)
    w0 = idx / n
    between = w0 * (1.0 - w0) * (m0 - m1) ** 2
    i_star = jnp.argmax(between) + 1                 # near group = ds[:i_star]
    thresh = 0.5 * (ds[i_star - 1] + ds[jnp.minimum(i_star, n - 1)])
    near_mean = csum[i_star - 1] / i_star
    far_mean = (total - csum[i_star - 1]) / jnp.maximum(n - i_star, 1)
    far_frac = 1.0 - i_star / n
    ok = ((far_mean >= sep * jnp.maximum(near_mean, 1e-12))
          & (far_mean >= min_far)
          & (far_frac >= min_frac) & (far_frac <= max_frac))
    return jnp.where(ok & (dist > thresh), jnp.int32(-1),
                     labels.astype(jnp.int32))
