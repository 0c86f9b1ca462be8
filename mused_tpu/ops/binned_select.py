"""Stride-binned kNN candidate selection for the rematerialized huge-window
sweep (blocked_affinity.fused_rowblock with ``select="binned"``).

The strip path builds a (block, n) similarity strip and runs approx_max_k
over all n columns.  Binned selection first max-reduces each row's strip
into ``nbins`` candidate bins, then runs EXACT top-k over the (block, nbins)
candidates — a selection over n/groups columns instead of n.

Binning is BY RESIDUE (slot = col % nbins), not by contiguous ranges:
event streams are near-sorted, so a row's true top-k columns cluster in
index space — contiguous bins (lax.approx_max_k's PartialReduce) collide
exactly there, while residue classes spread any <= nbins consecutive
columns into distinct bins (perfect recall on contiguous neighbor runs).

Candidate -> adjacency: budgeted exact top-k over the (block, nbins)
candidate values, and the GROUP id g of each winner (col = g * nbins +
slot) is stored as int8 — n/nbins <= 127 groups — so the candidate buffer
is f32 values + int8 groups.

Semantics mirror affinity.knn_adjacency_block (reference
matrix_operations.py:74-110 kNN-per-modality contract): invalid columns
and the self column rank at NEG; ties keep the lowest column index (the
lowest group wins via argmax's first-max rule, and the budgeted keep
prefers the lowest slot).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from mused_tpu.utils.runtime import platform_paths

NEG = -1e30


def binned_candidates_reference(sim: jax.Array, col_valid: jax.Array,
                                start, nbins: int):
    """Stride-binned candidates from a materialized (block, n) sim strip of
    rows [start, start+block).  Returns (vals (block, nbins) f32, grp
    (block, nbins) int8 group ids; global column = grp * nbins + slot)."""
    block, n = sim.shape
    g = n // nbins
    col_ids = jnp.arange(n)[None, :]
    row_ids = start + jnp.arange(block)[:, None]
    sim = jnp.where((col_valid[None, :]) & (row_ids != col_ids), sim, NEG)
    # col = grp * nbins + slot  ->  (block, g, nbins); lowest group wins
    # ties (argmax returns the first max)
    s = sim.reshape(block, g, nbins)
    vals = jnp.max(s, axis=1)
    grp = jnp.argmax(s, axis=1).astype(jnp.int8)
    return vals, grp


def budgeted_keep(vals: jax.Array, row_valid: jax.Array, k: int):
    """Exact-k candidate mask: the k-th candidate value thresholds the
    bins, and ties AT the threshold are admitted in slot order up to the
    remaining budget — at nbins == n this reproduces lax.top_k's
    lowest-index tie preference exactly; at a real reduction the tie order
    is deterministic-arbitrary (the reference's own argsort tie order is
    quicksort-arbitrary, SURVEY §2.4)."""
    kk = min(k, vals.shape[1])
    thr = jax.lax.top_k(vals, kk)[0][:, -1:]
    real = vals > NEG / 2
    above = (vals > thr) & real
    tie = (vals == thr) & real
    budget = kk - jnp.sum(above.astype(jnp.int32), axis=1, keepdims=True)
    order = jnp.cumsum(tie.astype(jnp.int32), axis=1)
    keep = above | (tie & (order <= budget))
    return keep & row_valid[:, None]


def adjacency_from_candidates(keeps, grps, n: int) -> jax.Array:
    """(block, n) bool adjacency from per-modality candidate masks —
    NO scatter: candidate (r, slot) with group g IS column g*nbins + slot,
    so the dense adjacency is one elementwise broadcast over
    (block, groups, nbins), and the modality union fuses into the same
    pass."""
    block, nbins = keeps[0].shape
    groups = n // nbins
    gids = jax.lax.broadcasted_iota(jnp.int8, (block, groups, nbins), 1)
    adj = None
    for keep, grp in zip(keeps, grps):
        m = keep[:, None, :] & (grp[:, None, :] == gids)
        adj = m if adj is None else (adj | m)
    return adj.reshape(block, n)


def pad_features_128(x: jax.Array) -> jax.Array:
    """Pad the feature axis to a multiple of 128 (zeros vanish in the
    dot/chord metrics)."""
    pad = (-x.shape[1]) % 128
    if pad == 0:
        return x
    return jnp.pad(x, ((0, 0), (0, pad)))


def resolve_select(cfg, n: int) -> tuple[str, int]:
    """Resolve PipelineConfig.huge_window_fused_select for an n-column
    blocked sweep: (select, nbins) for the blocked_affinity entry points.
    None = the platform's default (utils.runtime.platform_paths); explicit
    True forces the binned path, False the strip."""
    fuse_sel = cfg.huge_window_fused_select
    if fuse_sel is None:
        fuse_sel = platform_paths().binned_select
    nbins = default_nbins(n, k_max=3 * cfg.k_basis) if fuse_sel else 0
    return ("binned" if nbins else "strip"), nbins


def default_nbins(n: int, tn: int = 512, target_reduction: int = 64,
                  k_max: int = 0) -> int:
    """Largest divisor structure: nbins = n / g with g | (n // tn), g <=
    target_reduction, and at least ~8*k_max candidate bins when feasible
    (recall).  Returns 0 when tn does not divide n (the caller falls back
    to the strip path)."""
    if n % tn != 0:
        return 0
    groups = n // tn
    g = 1
    for cand in range(min(target_reduction, groups), 0, -1):
        if groups % cand == 0:
            g = cand
            break
    nbins = n // g
    while k_max and nbins < 8 * k_max and g > 1:
        g //= 2
        while groups % g != 0:
            g -= 1
        nbins = n // g
    return nbins
