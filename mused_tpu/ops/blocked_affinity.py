"""Rematerialized row-block affinity: fused adjacency blocks computed on the
fly, never materializing the full (n, n) matrix.

The reference's batch engine allocates a dense subset^2 float64 matrix
(reference matrix_operations.py:17 via main.py:139-141) — 180GB at its own
default subset of 150k rows, i.e. its default batch config cannot actually
run.  The answer here is rematerialization: any (B, n) row block of the
fused adjacency is a cheap function of the feature tensors (matmul sims +
top_k), so consumers that only need matrix-vector products (randomized SVD,
spectral power iteration) recompute blocks inside a `lax.scan` instead of
storing the matrix — the same FLOPs-for-memory trade as activation remat in
training.

`Columns` holds the full-subset device feature tensors + global statistics
(TF-IDF document frequencies) computed once.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from mused_tpu.ops import affinity
from mused_tpu.ops import binned_select as bs
from mused_tpu.ops import cand_matvec as cm
from mused_tpu.utils.runtime import platform_paths


class Columns(NamedTuple):
    """Full-subset device tensors for the five standard modalities, or the
    generic numeric layout (see ``generic_columns``)."""

    kinds: tuple               # static: modality type per tensor
    tensors: tuple             # one (n, d_m) array per modality
    valids: tuple              # one (n,) bool per modality
    idf: jax.Array | None      # (H_text,) for the text modality, else None

    @property
    def n(self) -> int:
        t = self.tensors[0]
        # hoisted-stats kinds (tags, default_safe) store (tensor, row_stats)
        return (t[0] if isinstance(t, tuple) else t).shape[0]


def standard_columns(wf, features_cfg=None) -> Columns:
    """Columns for the 5 standard modalities from a (Sparse)WindowFeatures
    batch.  Sparse tokens scatter to dense ON DEVICE (affinity.counts_from_
    tokens) so only the small id/count tensors cross the interconnect.

    ``features_cfg`` MUST be the pipeline's FeatureConfig when the window was
    hashed with non-default dims: the scatter target is sized from it, and
    ids >= the target dim would be silently dropped by JAX's out-of-bounds
    scatter semantics (wrong adjacency, no error)."""
    from mused_tpu.data.features import SparseWindowFeatures
    loc = jnp.asarray(wf.location)
    tim = jnp.asarray(wf.times)
    uid = jnp.asarray(wf.user_ids)
    if isinstance(wf, SparseWindowFeatures):
        if features_cfg is None:
            from mused_tpu.utils.config import FeatureConfig
            features_cfg = FeatureConfig()
        tags = affinity.counts_from_tokens(jnp.asarray(wf.tags_ids), None,
                                           features_cfg.tags_hash_dim)
        text = affinity.counts_from_tokens(jnp.asarray(wf.text_ids),
                                           jnp.asarray(wf.text_cnt),
                                           features_cfg.text_hash_dim)
    else:
        tags = jnp.asarray(wf.tags).astype(jnp.float32)
        text = jnp.asarray(wf.text).astype(jnp.float32)
    text_valid = jnp.sum(text, axis=1) > 0
    n_docs = jnp.maximum(jnp.sum(text_valid.astype(jnp.float32)), 1.0)
    df = jnp.sum((text > 0) & text_valid[:, None], axis=0).astype(jnp.float32)
    idf = jnp.log((1.0 + n_docs) / (1.0 + df)) + 1.0
    # idf-scale + L2-normalize ONCE here: inside the blocked sweeps this
    # preprocessing sat in the per-block loop body, recomputing an
    # O(n * H_text) elementwise pass for every row block (48x at 100k
    # windows)
    text = text * idf[None, :]
    text = text / jnp.maximum(jnp.linalg.norm(text, axis=1, keepdims=True),
                              1e-12)
    # "text_bf16": ONE bf16 tensor of the pre-scaled, pre-normalized rows.
    # The tensor cores multiply bf16 operands exactly and accumulate in f32, so
    # the only deviation from the f32 dot is the INPUT rounding (~4e-3
    # relative on unit vectors) — and adding the first-order split
    # correction (bf16 [hi, lo] with lo = x − hi; hi@hi + hi@lo + lo@hi
    # ≈ Precision.HIGH) was measured to change ZERO top-50 text kNN edges
    # on two 8k-row probe streams (the sparse synthetic events stream and
    # a rich 15-60-token Zipf-text stream: the 1/2/3-term edge sets are
    # bit-identical; all residual disagreement vs the f32 oracle is the
    # shared input rounding).  One dot is a third of the 3-term's FLOPs,
    # and the column store is half the HBM bytes.  The
    # "text_split" kind stays supported for callers wanting the ~f24
    # product on data where input rounding itself matters.
    text_bf16 = text.astype(jnp.bfloat16)
    tags_valid = (jnp.asarray(wf.tags_valid)
                  if getattr(wf, "tags_valid", None) is not None
                  else jnp.sum(tags, axis=1) > 0)
    loc_valid = jnp.all(jnp.isfinite(loc), axis=1)
    # tags ride with their hoisted row sums: the Jaccard union needs the
    # per-row token totals, and computing the column-side sum inside the
    # block sweep re-reduced the whole (n, H_tags) tensor once per block
    # (XLA does not LICM-hoist the reduction out of the scan).  A tuple
    # leaf flows
    # through every jit/shard_map boundary as an ordinary pytree.
    # tags store int8: the multi-hot counts are small ints <= the token
    # cap (24 < 127), so int8 is exact like bf16 — and the Jaccard
    # intersection becomes an int8 dot (int32 accumulate, twice the bf16
    # tensor-core rate) with the (n, H_tags) column panel at half the bf16
    # bytes besides.  inter is the same integer either way, so sims are
    # BIT-IDENTICAL across the strip and binned paths and every backend.
    # The Jaccard sums are
    # computed in f32 FIRST (sums up to H exceed int8's range).
    return Columns(
        kinds=("location_xyz", "time", "username", "tags", "text_bf16"),
        tensors=(_unit_xyz(loc, loc_valid), tim, uid,
                 (tags.astype(jnp.int8), jnp.sum(tags, axis=1)),
                 text_bf16),
        valids=(loc_valid,
                jnp.all(jnp.isfinite(tim), axis=1)
                & (tim[:, 0] != 0.0) & (tim[:, 1] != 0.0),
                uid >= 0,
                tags_valid,
                text_valid),
        idf=idf,
    )


def _unit_xyz(latlon, valid):
    """(n, 2) [lat, lon] degrees -> (n, 3) unit vectors (invalid rows at a
    fixed dummy point; they are masked out of every kNN anyway).  Hoisted
    out of the per-block loop: the conversion is O(n) trig, once per
    window, not once per row block."""
    r = jnp.deg2rad(jnp.where(valid[:, None], latlon, 0.0))
    return jnp.stack([jnp.cos(r[:, 0]) * jnp.cos(r[:, 1]),
                      jnp.cos(r[:, 0]) * jnp.sin(r[:, 1]),
                      jnp.sin(r[:, 0])], axis=1)


def split_bf16(x: jax.Array) -> jax.Array:
    """bf16 [hi | lo] split packing of f32 rows (lo = x − hi), feature width
    padded to a 128 multiple.

    ACCURACY (corrected, review r5): one dot of two packed tensors pairs
    the halves POSITION-WISE — hi@hi' + lo@lo' — it does NOT contain the
    cross terms hi@lo' + lo@hi' of the true 4-term product an earlier
    round claimed.  Since lo@lo' is O(eps^2), the packed dot's accuracy
    equals a plain bf16-INPUT dot (measured 1.23e-4 on unit vectors, vs
    4.2e-7 for the real multi-term product) — the same input-rounding
    class as the "text_bf16" kind, where 1-term vs 3-term was measured to
    flip ZERO top-50 kNN edges on realistic streams.  What the packing
    DOES deliver (and why it stays): the value is BACKEND-INDEPENDENT —
    XLA:CPU upcasts the same bf16 halves and sums the same two products,
    so the strip and stride-binned paths rank by the SAME sims on every
    backend (the DEFAULT dot on raw f32 operands rounds differently per
    backend and was measured flipping ~24% of kNN edges between modes).
    A SINGLE bf16 tensor (``bf16_pack``) achieves the identical accuracy
    class and backend independence at half this width; this layout stays
    for hand-built Columns."""
    hi = x.astype(jnp.bfloat16)
    lo = (x - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    return bs.pad_features_128(jnp.concatenate([hi, lo], axis=1))


def bf16_pack(x: jax.Array) -> jax.Array:
    """SINGLE bf16 tensor of f32 rows, feature width padded to a 128
    multiple — the packing generic_columns adopted in round 5 (the lever
    split_bf16's docstring documents): the positional packed dot of two
    split tensors is hi@hi' + lo@lo', whose accuracy ALREADY equals this
    plain bf16-input dot, so the split spent 2x the width (and 2x the dot
    cost + panel bytes) buying nothing.  Backend independence is identical:
    every backend upcasts the same bf16 values, so the strip and binned
    paths still rank by the SAME sims."""
    return bs.pad_features_128(x.astype(jnp.bfloat16))


def generic_columns(mats, types) -> Columns:
    """Columns for numeric modalities (default/embedding/location/time).

    Embedding rows normalize and default rows mask/hoist their squared
    norms HERE, once per window — inside the block sweep these were an
    extra full-panel elementwise pass per block, and the sweep is
    HBM-bandwidth-bound (same rationale as the hoisted text idf/normalize
    and tags row sums: the O(n·d) pass is FLOP-trivial but its read+write
    traffic rivals the column-panel read the matmul actually needs).  Both
    kinds store a SINGLE bf16 tensor (``bf16_pack``, round 5 — was the
    2x-width split_bf16 packing, whose positional dot has the same
    accuracy class; see split_bf16's correction note): identical kNN
    ranking across the strip and binned paths, at HALF the split
    packing's dot cost and panel bytes."""
    tensors, valids, kinds = [], [], []
    for m, t in zip(mats, types):
        m = jnp.asarray(np.asarray(m, np.float32))
        if t == "location":
            valid = jnp.all(jnp.isfinite(m), axis=1)
            tensors.append(_unit_xyz(m, valid))
            valids.append(valid)
            kinds.append("location_xyz")
            continue
        if t == "time":
            kinds.append(t)
            valids.append(jnp.all(jnp.isfinite(m), axis=1)
                          & (m[:, 0] != 0.0) & (m[:, 1] != 0.0))
            tensors.append(m)
        elif t == "embedding":
            fin = jnp.all(jnp.isfinite(m), axis=1)
            safe = jnp.where(fin[:, None], m, 0.0)
            norm = jnp.linalg.norm(safe, axis=1, keepdims=True)
            kinds.append("embedding_bf16")
            valids.append(fin & (norm[:, 0] > 0))
            tensors.append(bf16_pack(safe / jnp.maximum(norm, 1e-12)))
        elif t == "default":
            valid = jnp.all(jnp.isfinite(m), axis=1)
            safe = jnp.where(valid[:, None], m, 0.0)
            packed = bf16_pack(safe)
            # squared norms CONSISTENT WITH THE PACKED DOT (review r5
            # lineage): the hoisted norm is the dot's exact self-product
            # |bf16(x)|^2 — computed from the PACKED tensor, not the f32
            # original — so the chord cancellation is exact at self
            # (self-distance 0) and d2 >= 0 holds to f32 rounding.
            pf = packed.astype(jnp.float32)
            kinds.append("default_safe")
            valids.append(valid)
            tensors.append((packed, jnp.sum(pf * pf, axis=1)))
        else:
            kinds.append(t)
            valids.append(jnp.all(jnp.isfinite(m), axis=1))
            tensors.append(m)
    return Columns(kinds=tuple(kinds), tensors=tuple(tensors),
                   valids=tuple(valids), idf=None)


def _rows(t, start, size):
    return jax.lax.dynamic_slice_in_dim(t, start, size, axis=0)


def _count_dot(a, b):
    """f32 intersection counts a @ b.T for exact small-int count tensors —
    int8 operands take the int8 tensor-core path (exact int32 accumulate),
    everything else the bf16/f32 DEFAULT path; the result is the same
    integer either way (counts and their products are exact in both)."""
    if a.dtype == jnp.int8:
        return jnp.dot(a, b.T,
                       preferred_element_type=jnp.int32).astype(jnp.float32)
    return jnp.dot(a, b.T, preferred_element_type=jnp.float32)


def _modality_candidates(t, tr, valid, vr, k, metric, *, start, block: int,
                         n: int, nbins: int, row_sums=None, sim_fn=None):
    """(keep, grp) stride-binned candidates for one modality's row block.
    ``sim_fn`` builds the (block, n) sim strip for the non-dot metrics
    (chord3/l1).  Returns None at k == 0 (the modality contributes no
    edges)."""
    k = max(0, min(k, n - 1))
    if k == 0:
        return None
    if sim_fn is not None:
        sim = sim_fn()
    elif metric == "jaccard":
        inter = _count_dot(tr, t)
        s_r = (_rows(row_sums, start, block)[:, None]
               .astype(jnp.float32))
        sim = inter / jnp.maximum(
            s_r + row_sums[None, :].astype(jnp.float32) - inter, 1e-9)
    elif metric == "chord":
        sq_r = _rows(row_sums, start, block)
        sim = -jnp.maximum(
            sq_r[:, None] + row_sums[None, :]
            - 2.0 * jnp.dot(tr, t.T, preferred_element_type=jnp.float32),
            0.0)
    else:
        sim = jnp.dot(tr, t.T, preferred_element_type=jnp.float32)
    vals, grp = bs.binned_candidates_reference(sim, valid, start, nbins)
    return bs.budgeted_keep(vals, vr, k), grp


def _kind_cand_spec(kind: str, t, valid, k_basis: int, start, block: int,
                    n: int, extra=None):
    """Per-modality binned-candidate route: (t, tr, k, metric, row_sums,
    sim_fn) kwargs for :func:`_modality_candidates`, or None when ``kind``
    has no binned route (caller falls back to the dense strip).  ``extra``
    is the kind's hoisted row statistic (tags row sums / default_safe
    squared norms).  The ONE place the kind -> metric/k mapping lives —
    shared by fused_rowblock (dense OR-fusion) and candidate_rowblock
    (candidate-native fold), so the two paths select identical edges."""
    if kind in ("location", "location_xyz"):
        xc = _unit_xyz(t, valid) if kind == "location" else t
        xr = _rows(xc, start, block)
        return dict(
            t=xc, tr=xr, k=k_basis, metric="chord3",
            sim_fn=lambda: -(
                (xr[:, 0][:, None] - xc[:, 0][None, :]) ** 2
                + (xr[:, 1][:, None] - xc[:, 1][None, :]) ** 2
                + (xr[:, 2][:, None] - xc[:, 2][None, :]) ** 2))
    if kind == "time":
        tr = _rows(t, start, block)
        return dict(
            t=t, tr=tr, k=3 * k_basis, metric="l1",
            sim_fn=lambda: -(jnp.abs(tr[:, :1] - t[:, 0][None, :])
                             + jnp.abs(tr[:, 1:2] - t[:, 1][None, :])))
    if kind == "tags":
        if t.shape[1] % 128:
            return None
        sums = (jnp.sum(t.astype(jnp.float32), axis=1) if extra is None
                else extra)
        return dict(t=t, tr=_rows(t, start, block), k=k_basis,
                    metric="jaccard", row_sums=sums)
    if kind in ("text_bf16", "embedding_bf16", "embedding_split"):
        if t.shape[1] % 128:
            return None
        return dict(t=t, tr=_rows(t, start, block), k=k_basis, metric="dot")
    if kind == "default_safe":
        if t.shape[1] % 128:
            return None
        return dict(t=t, tr=_rows(t, start, block),
                    k=max(1, k_basis) - 1, metric="chord", row_sums=extra)
    return None


def fused_rowblock(cols: Columns, start, block: int,
                   k_basis: int, approx: bool = False,
                   select: str = "strip", nbins: int = 0,
                   out_dtype=jnp.float32) -> jax.Array:
    """(block, n) fused adjacency rows [start, start+block) — pure function of
    the feature tensors; `start` may be traced (used inside lax.scan).
    ``approx`` selects approx_max_k for the kNN selections (see
    affinity.knn_adjacency_block).

    ``select="binned"`` (with ``nbins`` from binned_select.default_nbins)
    routes every modality with a binned route (_kind_cand_spec) through
    stride-binned candidate selection (ops/binned_select.py): per-modality
    kNN becomes exact top-k over (block, nbins) candidates, and the union
    is one scatter-free broadcast.  Modalities without a binned route keep
    the strip path and OR in densely.

    Per-modality adjacencies are built as BOOL and OR-fused bitwise, with a
    single cast to f32 at the end: the sweep is HBM-bandwidth-bound and the
    five f32 (block, n) adjacency temporaries were ~1/3 of its traffic."""
    knn_b = functools.partial(affinity.knn_adjacency_block,
                              out_dtype=jnp.bool_)
    n = cols.n
    binned = select == "binned" and nbins > 0 and n % nbins == 0

    cand_cols = []
    mats = []
    for kind, t, valid in zip(cols.kinds, cols.tensors, cols.valids):
        tags_sum = def_sq = None
        if kind == "tags" and isinstance(t, tuple):
            t, tags_sum = t       # (multi_hot, hoisted row sums)
        if kind == "default_safe":
            t, def_sq = t         # (masked rows, hoisted squared norms)
        tr = _rows(t, start, block)
        vr = _rows(valid, start, block)
        if binned and kind != "username":
            extra = tags_sum if tags_sum is not None else def_sq
            spec = _kind_cand_spec(kind, t, valid, k_basis, start, block, n,
                                   extra)
            if spec is not None:
                cand_cols.append(_modality_candidates(
                    valid=valid, vr=vr, start=start, block=block, n=n,
                    nbins=nbins, **spec))
                continue
        if kind in ("location", "location_xyz"):
            # chord-distance ranking on 3D unit vectors: |a-b| is monotone
            # in the central angle, so the kNN sets equal haversine's — and
            # the pairwise trig (sin/cos/arcsin per PAIR, ~2G transcendentals
            # per block at 100k windows) collapses to three fused broadcast-
            # difference passes.  The differences keep full relative
            # precision at small angles (a plain unit-dot ranking saturates
            # at 1 - theta^2/2, where f32 cannot separate nearby points).
            # "location_xyz" tensors are pre-converted in the column
            # builders (once per window, not once per block); raw-latlon
            # "location" Columns convert here.
            if kind == "location":
                xc = _unit_xyz(t, valid)
                xr = _rows(xc, start, block)
            else:
                xc, xr = t, tr
            sim = -((xr[:, 0][:, None] - xc[:, 0][None, :]) ** 2
                    + (xr[:, 1][:, None] - xc[:, 1][None, :]) ** 2
                    + (xr[:, 2][:, None] - xc[:, 2][None, :]) ** 2)
            mats.append(knn_b(sim, vr, valid, k_basis, start, approx))
        elif kind == "time":
            sim = -(jnp.abs(tr[:, :1] - t[:, 0][None, :])
                    + jnp.abs(tr[:, 1:2] - t[:, 1][None, :]))
            mats.append(knn_b(sim, vr, valid, 3 * k_basis, start, approx))
        elif kind == "username":
            same = (tr[:, None] == t[None, :]) & vr[:, None] & valid[None, :]
            not_self = (start + jnp.arange(tr.shape[0]))[:, None] \
                != jnp.arange(cols.n)[None, :]
            mats.append(same & not_self)
        elif kind == "tags":
            sums = (jnp.sum(t.astype(jnp.float32), axis=1)
                    if tags_sum is None else tags_sum)
            # exact count dot (int8 path when the columns store int8;
            # bf16/f32 DEFAULT otherwise — same integers either way); this
            # dot is the (block, n) sweep's biggest FLOP bucket at 100k
            # windows
            inter = _count_dot(tr, t)
            s_r = (jnp.sum(tr.astype(jnp.float32), axis=1)
                   if tags_sum is None else _rows(tags_sum, start, block))
            # one fused elementwise pass: inter <= min(s_r, s_c) exactly
            # (counts and their sums are exact), so the union is >= 0 and
            # == 0 only where inter == 0, where the clamped quotient is 0 —
            # identical to where(union > 0, ...) but without the extra
            # (block, n) temporary round trip
            sim = inter / jnp.maximum(s_r[:, None] + sums[None, :] - inter,
                                      1e-9)
            mats.append(knn_b(sim, vr, valid, k_basis, start, approx))
        elif kind == "text_bf16":
            # pre-scaled/normalized bf16 columns (see standard_columns):
            # one DEFAULT-precision dot — bf16 operands multiply exactly
            # with f32 accumulation; measured rank-identical to the
            # split-term product on both probe streams
            sim = jnp.dot(tr, t.T, preferred_element_type=jnp.float32)
            mats.append(knn_b(sim, vr, valid, k_basis, start, approx))
        elif kind == "text_split":
            # bf16 [hi | lo] pre-split, pre-scaled/normalized columns:
            # hi@hi + hi@lo + lo@hi from three DEFAULT-precision half-width
            # dots == Precision.HIGH's 3-term product, with the operand
            # split hoisted out of the block loop — the high-precision
            # option for data where bf16 input rounding matters
            h = t.shape[1] // 2
            h_c, l_c = t[:, :h], t[:, h:]
            h_r = _rows(h_c, start, block)
            l_r = _rows(l_c, start, block)
            sim = (jnp.dot(h_r, h_c.T, preferred_element_type=jnp.float32)
                   + jnp.dot(h_r, l_c.T, preferred_element_type=jnp.float32)
                   + jnp.dot(l_r, h_c.T, preferred_element_type=jnp.float32))
            mats.append(knn_b(sim, vr, valid, k_basis, start, approx))
        elif kind in ("text", "text_norm"):
            if kind == "text_norm":     # pre-scaled/normalized — plain dot
                x_c = t
            else:
                # raw-counts "text" (e.g. a generic stream naming the type):
                # idf-scale when stats are available, else plain cosine
                x_c = t if cols.idf is None else t * cols.idf[None, :]
                x_c = x_c / jnp.maximum(
                    jnp.linalg.norm(x_c, axis=1, keepdims=True), 1e-12)
            x_r = _rows(x_c, start, block)
            # Precision.HIGH (3-pass bf16 products): measured on a real 32k
            # window, DEFAULT single-pass bf16 perturbs idf-scaled sims by
            # up to 5e-3, flipping ~24% of text kNN edges as genuine rank
            # inversions (not tie churn) — HIGH restores ~f32 ranking at a
            # third of the HIGHEST cost.  CPU (the test oracle) is exact
            # f32 under every setting.
            sim = jnp.dot(x_r, x_c.T, preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGH)
            mats.append(knn_b(sim, vr, valid, k_basis, start, approx))
        elif kind in ("embedding_bf16", "embedding_split"):
            # rows pre-normalized and bf16-packed in generic_columns (see
            # bf16_pack; "embedding_split" is the legacy 2x-width [hi|lo]
            # layout for hand-built Columns — its positional dot has the
            # SAME bf16-input accuracy class, see split_bf16): one DEFAULT
            # dot, identical ranking on the strip and binned paths
            sim = jnp.dot(tr, t.T, preferred_element_type=jnp.float32)
            mats.append(knn_b(sim, vr, valid, k_basis, start, approx))
        elif kind == "embedding_unit":
            # legacy layout: pre-normalized f32 rows (callers assembling
            # Columns by hand); exact f32 dot, strip-only
            sim = jnp.dot(tr, t.T, preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
            mats.append(knn_b(sim, vr, valid, k_basis, start, approx))
        elif kind == "embedding":
            x_c = t / jnp.maximum(jnp.linalg.norm(t, axis=1, keepdims=True),
                                  1e-12)
            x_r = _rows(x_c, start, block)
            sim = jnp.dot(x_r, x_c.T, preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
            mats.append(knn_b(sim, vr, valid, k_basis, start, approx))
        elif kind == "default_safe":
            # masked bf16-packed rows + hoisted squared norms (see
            # generic_columns); negative squared euclidean == the binned
            # "chord" metric, self included in k (ref :112-119).  The
            # bf16-operand dot keeps d2 IDENTICAL across the strip and
            # binned paths, and the hoisted norms are the dot's exact
            # self-product, so self-distance is 0 and d2 >= 0
            kk = max(1, k_basis) - 1
            d2 = (_rows(def_sq, start, block)[:, None] + def_sq[None, :]
                  - 2.0 * jnp.dot(tr, t.T,
                                  preferred_element_type=jnp.float32))
            mats.append(knn_b(-jnp.maximum(d2, 0.0), vr, valid, kk,
                              start, approx))
        else:   # default: euclidean, self included in k (ref :112-119)
            safe_c = jnp.where(valid[:, None], t, 0.0)
            safe_r = jnp.where(vr[:, None], tr, 0.0)
            sq_r = jnp.sum(safe_r * safe_r, axis=1)
            sq_c = jnp.sum(safe_c * safe_c, axis=1)
            d2 = sq_r[:, None] + sq_c[None, :] - 2.0 * jnp.dot(
                safe_r, safe_c.T, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
            mats.append(knn_b(-jnp.maximum(d2, 0.0), vr, valid,
                              max(1, k_basis) - 1, start, approx))
    cand_cols = [c for c in cand_cols if c is not None]
    if cand_cols:
        # scatter-free union: candidate (r, slot, grp) IS column
        # grp*nbins + slot, so the dense edges for every binned modality
        # build in ONE fused elementwise broadcast; dense modalities OR in
        fused = bs.adjacency_from_candidates(
            [k for k, _ in cand_cols], [g for _, g in cand_cols], cols.n)
        for m in mats:
            fused = fused | m
    elif mats:
        fused = mats[0]
        for m in mats[1:]:
            fused = fused | m
    else:
        # every modality skipped (k clamps to 0 everywhere, e.g. n == 1):
        # zero edges, matching the strip path's k=0 behavior
        fused = jnp.zeros((block, cols.n), jnp.bool_)
    # out_dtype=bfloat16 for the FD fold: the 0/1 edges are bf16-exact and
    # the fold's G-applications are HBM-bound on re-reading this block —
    # half the bytes is pure bandwidth (fd.shrink_rr_pair)
    return fused.astype(out_dtype)


# ---------------------------------------------------------------------------
# candidate-form row blocks (the dense block never materializes)
# ---------------------------------------------------------------------------


def cand_fold_supported(kinds, tensors, nbins: int, n: int) -> bool:
    """True when EVERY modality of the window either has a stride-binned
    candidate route (_kind_cand_spec) or is the username equality modality
    (evaluated inside the candidate products) — the precondition for the
    candidate-native FD fold, which has no dense strip to OR into."""
    if nbins <= 0 or n % nbins or (n // nbins) > 127:
        return False
    for kind, t in zip(kinds, tensors):
        if kind == "username":
            continue
        tt = t[0] if isinstance(t, tuple) else t
        if kind in ("location", "location_xyz", "time"):
            continue
        if kind in ("tags", "text_bf16", "embedding_bf16", "embedding_split",
                    "default_safe"):
            if tt.shape[1] % 128:
                return False
            continue
        return False
    return True


def candidate_rowblock(cols: Columns, start, block: int, k_basis: int,
                       nbins: int):
    """Candidate-form fused adjacency rows [start, start+block): the same
    edges as ``fused_rowblock(select="binned")`` — same candidates, same
    budgeted_keep, username via uid equality — packed as int8 slabs
    (ops/cand_matvec.CandBlock) instead of a dense (block, n) block.
    Callers must have checked :func:`cand_fold_supported`."""
    n = cols.n
    slabs, uid_rows, uid_cols = [], None, None
    for kind, t, valid in zip(cols.kinds, cols.tensors, cols.valids):
        extra = None
        if isinstance(t, tuple):
            t, extra = t
        if kind == "username":
            uid_rows, uid_cols = cm.mask_uids(t, valid, nbins, start, block)
            continue
        spec = _kind_cand_spec(kind, t, valid, k_basis, start, block, n,
                               extra)
        assert spec is not None, f"kind {kind!r} has no candidate route"
        res = _modality_candidates(
            valid=valid, vr=_rows(valid, start, block), start=start,
            block=block, n=n, nbins=nbins, **spec)
        if res is None:          # k == 0 — modality contributes no edges
            continue
        keep, grp = res
        slabs.append(cm.pack_slab(keep, grp))
    if not slabs:                # username-only (or all-k=0) windows
        slabs = [jnp.full((block, nbins), -1, jnp.int8)]
    if uid_cols is None:
        uid_cols = jnp.full((n // nbins, nbins), -2, jnp.int32)
    return cm.CandBlock(jnp.stack(slabs), uid_rows, uid_cols,
                        jnp.asarray(start, jnp.int32))


@functools.partial(jax.jit,
                   static_argnames=("kinds", "ell", "block", "k_basis",
                                    "nbins"))
def _blocked_fd_cands_impl(tensors, valids, idf, *, kinds, ell: int,
                           block: int, k_basis: int, nbins: int):
    """Candidate-native huge-window FD fold: each scan step builds the
    block's candidates and absorbs them via fd.shrink_rr_cands, whose
    products rebuild the adjacency one column group at a time from the
    int8 slabs (ops/cand_matvec)."""
    from mused_tpu.ops import fd
    cols = Columns(kinds=kinds, tensors=tensors, valids=valids, idf=idf)
    n = cols.n
    assert n % block == 0, "choose block dividing n (pad rows upstream)"

    def body(st, i):
        start = i * block
        cand = candidate_rowblock(cols, start, block, k_basis, nbins)
        b, delta, edges = fd.shrink_rr_cands(st.sketch, cand, ell)
        return fd.FDState(
            sketch=b,
            sq_frobenius=st.sq_frobenius + edges,
            shrink_loss=st.shrink_loss + delta,
            count=st.count + jnp.int32(block)), None

    state, _ = jax.lax.scan(body, fd.init(ell, n), jnp.arange(n // block))
    return state.sketch, state.sq_frobenius, state.shrink_loss


# ---------------------------------------------------------------------------
# blocked randomized SVD of the implicit fused adjacency
# ---------------------------------------------------------------------------


def randomized_svd_from_products(mul_a, mul_at, key: jax.Array, *, n: int,
                                 rank: int, oversample: int = 8,
                                 n_iter: int = 2) -> jax.Array:
    """Randomized truncated SVD U·S of an implicit (n, n) matrix given only
    its products: ``mul_a(v) = A @ v`` and ``mul_at(v) = A^T @ v`` for
    (n, r) panels (reference TruncatedSVD, matrix_operations.py:143-147).

    The ONE copy of the recipe (omega stream, QR power iteration, small SVD,
    rank zero-pad) shared by the single-chip blocked sweep and the
    row-/column-sharded layouts (parallel/sharded, parallel/colsharded) —
    their "same recipe, parity to rounding" guarantee holds because only
    the product closures differ."""
    r = min(rank + oversample, n)
    omega = jax.random.normal(key, (n, r), jnp.float32)
    q, _ = jnp.linalg.qr(mul_a(omega))
    for _ in range(n_iter):
        z, _ = jnp.linalg.qr(mul_at(q))
        q, _ = jnp.linalg.qr(mul_a(z))
    bt = mul_at(q)                           # (n, r) = A^T Q
    ub, s, _ = jnp.linalg.svd(bt.T, full_matrices=False)
    out = (q @ ub)[:, :rank] * s[None, :rank]
    if rank > out.shape[1]:
        out = jnp.concatenate(
            [out, jnp.zeros((n, rank - out.shape[1]), out.dtype)], axis=1)
    return out


def hoist_columns(cols: Columns) -> Columns:
    """Normalize hand-assembled Columns to the hoisted forms the per-block
    sweeps assume (review r5): a raw 'location' latlon panel converts to
    unit xyz ONCE (O(n) trig — left inside the scan it re-ran per row
    block), and untupled 'tags' gain their hoisted row sums (the per-block
    full-panel re-reduction the tuple exists to avoid).  standard_columns /
    generic_columns already emit hoisted kinds, so this is a no-op
    pass-through for them."""
    kinds = list(cols.kinds)
    tensors = list(cols.tensors)
    changed = False
    for i, (k, t, v) in enumerate(zip(kinds, tensors, cols.valids)):
        if k == "location":
            kinds[i] = "location_xyz"
            tensors[i] = _unit_xyz(jnp.asarray(t, jnp.float32), v)
            changed = True
        elif k == "tags" and not isinstance(t, tuple):
            tensors[i] = (t, jnp.sum(jnp.asarray(t).astype(jnp.float32),
                                     axis=1))
            changed = True
    if not changed:
        return cols
    return Columns(kinds=tuple(kinds), tensors=tuple(tensors),
                   valids=cols.valids, idf=cols.idf)


def _scan_blocks(cols: Columns, block: int, k_basis: int, f, init,
                 approx: bool = False, select: str = "strip",
                 nbins: int = 0, out_dtype=jnp.float32):
    """fold f(carry, fused_block, start) over all row blocks via lax.scan."""
    cols = hoist_columns(cols)          # once per sweep, not once per block
    n = cols.n
    n_blocks = -(-n // block)

    def body(carry, i):
        start = i * block
        # clamp the last block's start so slices stay in range; the overlap
        # rows are recomputed identically and masked by the caller via
        # row-index arithmetic where needed
        start = jnp.minimum(start, n - block)
        fused = fused_rowblock(cols, start, block, k_basis, approx,
                               select, nbins, out_dtype)
        return f(carry, fused, start), None

    carry, _ = jax.lax.scan(body, init, jnp.arange(n_blocks))
    return carry


def blocked_fd_sketch(cols: Columns, *, ell: int, block: int,
                      k_basis: int, mode: str = "subspace",
                      approx_knn: bool = False, select: str = "strip",
                      nbins: int = 0, cand_fold: bool | None = None):
    """FD sketch (ell, n) of the implicit fused adjacency's rows, one
    rematerialized sweep (the huge-window SWFDMC regime, BASELINE.md #3:
    windows too large to materialize even once).

    ``mode`` selects the shrink (ops/fd.py): "subspace" (default) routes to
    the Rayleigh-Ritz shrink (fd.shrink_rr) — at fold scale (d = n ~ 100k)
    the Gram matmul dominates and the Newton-Schulz chain both adds a long
    chain of sequential tiny matmuls per absorb AND fails its health gate on
    real adjacency stacks (orth_err 0.5-1.0 measured), so rr IS the subspace
    shrink tuned for huge d.  "eigh" keeps classic FD; "rr"/"subspace_ns"
    select explicitly.

    ``cand_fold``: absorb CANDIDATE-form blocks (fd.shrink_rr_cands +
    ops/cand_matvec) — the fold's products rebuild the adjacency one
    column group at a time from the int8 candidate slabs.  Requires the rr
    shrink, binned selection, and every modality binned-eligible
    (cand_fold_supported).  None = the platform's default when eligible
    (utils.runtime.platform_paths).  Edges are identical to the dense
    binned path by construction (same candidates + budgeted_keep);
    products differ only in f32 summation order and bf16 operand rounding
    of the probe/bound vectors (docs/DESIGN.md §8.4).

    Returns (sketch, sq_frobenius, shrink_loss) — feed to swfd.absorb_summary
    exactly like fd.fold_sketch's output.
    """
    from mused_tpu.ops import fd
    mode = fd.resolve_fold_mode(mode)
    eligible = (mode == "rr" and select == "binned" and cols.n % block == 0
                and cand_fold_supported(cols.kinds, cols.tensors, nbins,
                                        cols.n))
    if cand_fold is None:
        cand_fold = eligible and platform_paths().cand_fold
    elif cand_fold and not eligible:
        raise ValueError(
            "cand_fold=True needs the rr shrink, select='binned', "
            "block | n, and every modality binned-eligible "
            "(cand_fold_supported)")
    if cand_fold:
        return _blocked_fd_cands_impl(
            cols.tensors, cols.valids, cols.idf, kinds=cols.kinds, ell=ell,
            block=block, k_basis=k_basis, nbins=nbins)
    return _blocked_fd_impl(cols.tensors, cols.valids, cols.idf,
                            kinds=cols.kinds, ell=ell, block=block,
                            k_basis=k_basis, mode=mode,
                            approx_knn=approx_knn, select=select,
                            nbins=nbins)


@functools.partial(jax.jit,
                   static_argnames=("kinds", "ell", "block", "k_basis",
                                    "mode", "approx_knn", "select", "nbins"))
def _blocked_fd_impl(tensors, valids, idf, *, kinds, ell: int, block: int,
                     k_basis: int, mode: str = "subspace",
                     approx_knn: bool = False, select: str = "strip",
                     nbins: int = 0):
    from mused_tpu.ops import fd
    cols = Columns(kinds=kinds, tensors=tensors, valids=valids, idf=idf)
    n = cols.n
    # _scan_blocks clamps the last block's start when block does not divide
    # n, recomputing overlap rows — the FD fold would absorb those twice and
    # silently bias the sketch (callers pad rows upstream, like blocked_svd)
    assert n % block == 0, "choose block dividing n (pad rows upstream)"

    def f(state, fused, start):
        return fd.update_stream(state, fused, mode=mode)

    # rr folds absorb split-operand and read the block several times: bf16
    # 0/1 edges are exact and halve every read (fd.shrink_rr_pair)
    out_dtype = jnp.bfloat16 if mode == "rr" else jnp.float32
    state = _scan_blocks(cols, block, k_basis, f, fd.init(ell, n),
                         approx=approx_knn, select=select, nbins=nbins,
                         out_dtype=out_dtype)
    return state.sketch, state.sq_frobenius, state.shrink_loss


def blocked_svd_reduce(cols: Columns, key: jax.Array, *, rank: int,
                       block: int, k_basis: int, n_iter: int = 2,
                       oversample: int = 8, approx_knn: bool = False,
                       select: str = "strip", nbins: int = 0) -> jax.Array:
    """TruncatedSVD.fit_transform of the implicit fused adjacency, computed
    with (2 + 2*n_iter) rematerialized sweeps over row blocks.

    Requires block <= n and block | n for exactness of the row coverage
    (the driver pads/chooses block accordingly); returns (n, rank) = U*S.
    """
    # kinds are static python strings -> route them around jit explicitly
    return _blocked_svd_impl(
        cols.tensors, cols.valids, cols.idf, key, kinds=cols.kinds,
        rank=rank, block=block, k_basis=k_basis, n_iter=n_iter,
        oversample=oversample, approx_knn=approx_knn, select=select,
        nbins=nbins)


@functools.partial(jax.jit,
                   static_argnames=("kinds", "block", "k_basis", "rank",
                                    "n_iter", "oversample", "approx_knn",
                                    "select", "nbins"))
def _blocked_svd_impl(tensors, valids, idf, key, *, kinds, rank: int,
                      block: int, k_basis: int, n_iter: int,
                      oversample: int, approx_knn: bool = False,
                      select: str = "strip", nbins: int = 0) -> jax.Array:
    cols = Columns(kinds=kinds, tensors=tensors, valids=valids, idf=idf)
    n = cols.n
    assert n % block == 0, "choose block dividing n (pad rows upstream)"
    r = min(rank + oversample, n)

    # the 0/1 fused blocks are bf16-exact, and every sweep product reads
    # the freshly built block once: bf16 halves that traffic.  The matvec
    # converts to f32 in the dot's operand load (f32 accumulation).
    def mul_A(v):          # A @ v via block sweep: (n, r)
        def f(acc, fused, start):
            return jax.lax.dynamic_update_slice_in_dim(
                acc, jnp.dot(fused.astype(jnp.float32), v,
                             preferred_element_type=jnp.float32),
                start, axis=0)
        return _scan_blocks(cols, block, k_basis, f, jnp.zeros((n, r)),
                            approx=approx_knn, select=select, nbins=nbins,
                            out_dtype=jnp.bfloat16)

    def mul_AT(v):         # A^T @ v via block sweep: (n, r)
        def f(acc, fused, start):
            vb = jax.lax.dynamic_slice_in_dim(v, start, block, axis=0)
            return acc + jnp.dot(fused.astype(jnp.float32).T, vb,
                                 preferred_element_type=jnp.float32)
        return _scan_blocks(cols, block, k_basis, f, jnp.zeros((n, r)),
                            approx=approx_knn, select=select, nbins=nbins,
                            out_dtype=jnp.bfloat16)

    return randomized_svd_from_products(mul_A, mul_AT, key, n=n, rank=rank,
                                        oversample=oversample, n_iter=n_iter)
