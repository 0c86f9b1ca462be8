"""Row-sharded KMeans: SPMD Lloyd iterations over the mesh "data" axis.

Each chip owns a row shard of the points; per iteration it assigns its rows
locally (matmul distance block) and contributes partial centroid sums/counts via
``psum`` — the classic data-parallel KMeans.  Centroids stay replicated (tiny:
k_max x d).  Matches ops.kmeans semantics (dynamic k masking, kmeans++ init,
shift tolerance) so single-chip and multi-chip results agree up to fp
reduction order.

kmeans++ seeding needs global argmax-style sampling; it runs REPLICATED
on the (already replicated) reduced matrix OUTSIDE the shard_map body —
no chip-0 gather/broadcast exists (every chip traces the identical
computation) — seeding is O(k*n*d), not the hot loop.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mused_tpu.ops import kmeans as km

shard_map = jax.shard_map


def _sharded_lloyd(x_shard, centroids0, alive, max_iters: int, tol: float,
                   axis_name: str = "data"):
    """shard_map body: Lloyd iterations with psum'd centroid accumulation."""
    k_max, d = centroids0.shape
    _local_sq_dists = km._sq_dists

    def assign(c):
        dist = km._sq_dists(x_shard, c)
        dist = jnp.where(alive[None, :], dist, jnp.inf)
        return jnp.argmin(dist, axis=1)

    def body(state):
        c, _, it = state
        labels = assign(c)
        onehot = (labels[:, None] == jnp.arange(k_max)[None, :]).astype(jnp.float32)
        counts = jax.lax.psum(jnp.sum(onehot, axis=0), axis_name)
        sums = jax.lax.psum(
            jnp.dot(onehot.T, x_shard, preferred_element_type=jnp.float32),
            axis_name)
        new_c = jnp.where((counts > 0)[:, None],
                          sums / jnp.maximum(counts, 1.0)[:, None], c)
        # empty-cluster relocation, matching ops.kmeans: gather each shard's
        # worst-fit candidates and pick the global top-k
        empty = alive & (counts == 0)

        def relocate(nc):
            m = x_shard.shape[0]
            dist_to_own = jnp.take_along_axis(
                _local_sq_dists(x_shard, nc), labels[:, None], axis=1)[:, 0]
            k_loc = min(k_max, m)
            vals, idx = jax.lax.top_k(dist_to_own, k_loc)
            cand_x = jax.lax.all_gather(x_shard[idx], axis_name).reshape(-1, d)
            cand_v = jax.lax.all_gather(vals, axis_name).reshape(-1)
            k_eff = min(k_max, cand_v.shape[0])
            _, gidx = jax.lax.top_k(cand_v, k_eff)
            slot = jnp.cumsum(empty.astype(jnp.int32)) - 1
            reloc = cand_x[gidx[jnp.clip(slot, 0, k_eff - 1)]]
            return jnp.where(empty[:, None], reloc, nc)

        new_c = jax.lax.cond(jnp.any(empty), relocate, lambda nc: nc, new_c)
        shift = jnp.sum((new_c - c) ** 2)
        return new_c, shift, it + 1

    def cond(state):
        return (state[1] > tol) & (state[2] < max_iters)

    centroids, _, _ = jax.lax.while_loop(
        cond, body, (centroids0, jnp.asarray(jnp.inf), 0))
    return assign(centroids).astype(jnp.int32), centroids


@functools.partial(jax.jit, static_argnames=("k_max", "max_iters", "mesh"))
def kmeans_sharded(x: jax.Array, k: jax.Array, key: jax.Array, *, k_max: int,
                   mesh, max_iters: int = 100, tol: float = 1e-4):
    """Row-sharded KMeans over the mesh "data" axis.

    x: (n, d) with n divisible by the data-axis size.  Returns
    (labels (n,), centroids (k_max, d)).
    """
    x = x.astype(jnp.float32)
    k = jnp.asarray(k, jnp.int32)
    alive = jnp.arange(k_max) < k
    centroids0 = km._kmeanspp_init(x, k_max, k, key)     # small, replicated

    def body(x_s):
        labels, cents = _sharded_lloyd(x_s, centroids0, alive, max_iters, tol)
        return labels, cents[None]

    labels, cents = shard_map(
        body, mesh=mesh,
        in_specs=P("data", None),
        out_specs=(P("data"), P("data", None, None)),
        check_vma=False,
    )(x)
    return labels, cents[0]
