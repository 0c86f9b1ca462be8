"""Fused-adjacency products straight from stride-binned kNN candidates.

The huge-window fold (reference main.py:58-76 SWFD semantics at windows the
reference could never materialize) consumes (block, n) fused adjacency
blocks only through matrix products — ``rows^T @ v`` and ``rows @ y`` inside
fd.shrink_rr_cands.  Here the rows live as compact int8 candidate slabs
(ops/binned_select), and each column group's (block, nbins) 0/1 tile is
rebuilt from the slabs right before its product.  The fused-OR union across
modalities and the reference's username equality modality (all rows sharing
a user id, reference matrix_operations.py:55-72) are evaluated inside the
tile build, so the products see exactly the same fused adjacency as
blocked_affinity.fused_rowblock.

Candidate slab encoding (one int8 per (row, slot) per binned modality):
    slab[r, s] = group id g of the kept candidate   (column = g*nbins + s)
               = -1 when slot s holds no kept candidate for row r
Group membership for column tile g is then ONE equality compare per
modality; the union is a bitwise OR of the compares.

Semantics notes:
  - Binned candidates already exclude invalid and self columns (see
    ops/binned_select.py); only the username equality needs the explicit
    not-self mask here.
  - Invalid uids are pre-masked by the caller to -1 (rows) / -2 (columns)
    so invalid never matches anything, mirroring ``uid >= 0`` validity.
  - Products are bf16 x bf16 with f32 accumulation.  The 0/1 masks are
    bf16-EXACT, so a product with a bf16 operand x equals the f32 product
    of x rounded to bf16; callers needing ~f32 operand precision pass the
    split [hi | lo] packing (hi = bf16(x), lo = bf16(x - hi)) as extra
    columns and sum the halves.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class CandBlock(NamedTuple):
    """Candidate-form fused adjacency rows [start, start+block) of an
    implicit (n, n) fused kNN adjacency (n = groups * nbins).

    ``g0`` is the GLOBAL id of local group 0 (column c of local group g is
    globally (g0 + g) * nbins + s): 0 on the single-chip path; on the
    column-sharded layout (parallel/colsharded) each chip folds only the
    groups it owns, with slabs re-encoded to LOCAL ids and g0 = its global
    group offset — the username col ids and the self-column compare stay
    globally correct while slab compares stay int8."""

    slabs: jax.Array            # (M, block, nbins) int8: LOCAL grp or -1
    uid_rows: jax.Array | None  # (block, 1) int32, -1 where invalid
    uid_cols: jax.Array         # (groups, nbins) int32, -2 where invalid
    start: jax.Array            # () int32 — global row offset
    g0: jax.Array | int = 0     # () int32 — global group offset

    @property
    def block(self) -> int:
        return self.slabs.shape[1]

    @property
    def nbins(self) -> int:
        return self.slabs.shape[2]


def pack_slab(keep: jax.Array, grp: jax.Array) -> jax.Array:
    """(block, nbins) int8 slab from budgeted_keep's mask + group ids."""
    return jnp.where(keep, grp, jnp.int8(-1))


def mask_uids(uid: jax.Array, valid: jax.Array, nbins: int,
              rows_start=None, block: int | None = None):
    """(uid_rows, uid_cols) operands for a CandBlock from the window's
    (n,) int32 uids + validity.  ``rows_start``/``block`` slice the row
    side (traced start ok); cols reshape to (groups, nbins) — column
    c = g*nbins + s lands at [g, s]."""
    ucol = jnp.where(valid, uid, -2).reshape(-1, nbins).astype(jnp.int32)
    urow_full = jnp.where(valid, uid, -1).astype(jnp.int32)
    if rows_start is None:
        urow = urow_full
    else:
        urow = jax.lax.dynamic_slice_in_dim(urow_full, rows_start, block)
    return urow.reshape(-1, 1), ucol


def dense_tile(cand: CandBlock, g: int | jax.Array) -> jax.Array:
    """(block, nbins) bool fused tile of local column group g."""
    tm, nbins = cand.block, cand.nbins
    gi8 = jnp.asarray(g, jnp.int8)
    mask = cand.slabs[0] == gi8
    for m in range(1, cand.slabs.shape[0]):
        mask = mask | (cand.slabs[m] == gi8)
    if cand.uid_rows is not None:
        same = cand.uid_rows == cand.uid_cols[g][None, :]
        row_ids = cand.start + jnp.arange(tm)[:, None]
        col_ids = ((jnp.asarray(cand.g0, jnp.int32) + g) * nbins
                   + jnp.arange(nbins))
        mask = mask | (same & (row_ids != col_ids[None, :]))
    return mask


def dense_rows(cand: CandBlock) -> jax.Array:
    """(block, n) bool fused adjacency rows — concatenated group tiles."""
    groups = cand.uid_cols.shape[0]
    return jnp.concatenate([dense_tile(cand, g) for g in range(groups)],
                           axis=1)


def matvec_t(cand: CandBlock, x_t: jax.Array):
    """rows^T @ x for the implicit fused rows, one product per column
    group: x_t is x PRE-TRANSPOSED (r, block) bf16; returns (out_t (r, n)
    f32, edges () f32) with edges == ||rows||_F^2, the exact fused edge
    count."""
    groups = cand.uid_cols.shape[0]
    outs, edges = [], jnp.float32(0.0)
    for g in range(groups):
        w = dense_tile(cand, g).astype(jnp.bfloat16)
        outs.append(jnp.dot(x_t, w, preferred_element_type=jnp.float32))
        edges = edges + jnp.sum(w.astype(jnp.float32))
    return jnp.concatenate(outs, axis=1), edges


def matvec(cand: CandBlock, y: jax.Array):
    """rows @ y for the implicit fused rows: y (n, r) bf16; returns
    (block, r) f32, accumulated over the column groups."""
    groups = cand.uid_cols.shape[0]
    nbins = cand.nbins
    out = jnp.zeros((cand.block, y.shape[1]), jnp.float32)
    for g in range(groups):
        w = dense_tile(cand, g).astype(jnp.bfloat16)
        out = out + jnp.dot(w, y[g * nbins:(g + 1) * nbins],
                            preferred_element_type=jnp.float32)
    return out
