"""Column-sharded huge-window sweep — the TP / sequence-parallel analog.

The row-sharded huge-window path (parallel/sharded.sharded_blocked_fd_sketch)
REPLICATES the window's column feature tensors on every chip: each chip
rematerializes its own range of (block, n) adjacency row blocks against the
full column panels.  That is the throughput-optimal layout, but it caps the
window size at one chip's HBM — at n window rows the replicated dense text
panel alone is n * text_hash_dim bf16 bytes (~0.8 GB at n≈100k, ~8 GB at
n≈1M), with the tags panel close behind.

This module removes that ceiling by sharding the FEATURES themselves: the
window-row axis shards over the mesh "data" axis, so chip q owns rows
[q·n/p, (q+1)·n/p) — which are also that chip's adjacency COLUMNS (the fused
matrix is n×n over the same rows).  Every chip sweeps EVERY row block, but
only its (block, n/p) column slice:

  per row block b (lockstep on all chips):
    row panel = psum(owner chip's slice)                  — O(block·K) link
    stride-binned kNN candidates over the local columns
      (ops/binned_select)
    global candidate merge: pmax values, then pmin of the
      achieving global group                              — O(block·nbins) link
      (bit-identical tie semantics to the single-chip binned path: the
       lowest global group among achievers of the max wins)
    replicated exact top-k (budgeted_keep) -> each chip's
      (block, n/p) adjacency slice, scatter-free
    column-sharded FD absorb: every contraction over the
      sharded d axis is a psum of a small (m2, r) product

The FD shrink math is identical to the single-chip shrinks (ops/fd.py:
shrink / shrink_rr_pair — same bound arguments, same honest trace-residual
accounting); only the f32 summation order differs (per-shard partial sums
combined by the psum).  The per-absorb collectives are tiny: (m2, r) and
(r, r) products at m2 = ell + block, r = ell + oversample.

Work decomposition vs the row-sharded layout: p chips × (n/block) blocks ×
(n/p) columns here, vs p chips × (n/(p·block)) blocks × n columns there —
the same total FLOPs, traded for p× less feature/panel HBM per chip.  Use
"rows" for throughput when the features fit; "columns" when they do not
(PipelineConfig.huge_window_layout).

GRID composition (the DP×TP shape): on a (pd, pm) mesh with pm > 1, the
feature columns shard pm ways over "model" (memory) AND the row blocks
shard pd ways over "data" (throughput) — each of the pd row groups sweeps
its own range of blocks over its pm column shards, then the pd per-group
column-sharded sketches merge with ONE more psum'd-Gram shrink over the
gathered (pd·ell, n/pm) stack (FD mergeability, SURVEY.md §2.8; the merge
delta is added to the honest loss).  The mesh shape IS the layout: a
(p, 1) mesh selects pure column sharding, (pd, pm>1) the grid.

Reference behavior reproduced: the per-modality kNN adjacency conventions of
reference matrix_operations.py:14-132 (per-modality k, validity,
self-exclusion, OR fusion :134-141) and the whole-window sketch feed of
reference main.py:58-76 — re-decomposed for a device mesh; the reference
is single-process NumPy and cannot run this regime at all.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from mused_tpu.ops import affinity, fd
from mused_tpu.ops import binned_select as bs
from mused_tpu.ops import blocked_affinity as ba
from mused_tpu.ops import cand_matvec as cm
from mused_tpu.utils.runtime import platform_paths

shard_map = jax.shard_map

_AXIS = "data"


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def default_nbins_colsharded(n: int, p: int, target_reduction: int = 64,
                             k_max: int = 0, nbins_cap: int = 4096) -> int:
    """Candidate-bin count for a p-way column-sharded sweep.

    Same structure as binned_select.default_nbins (nbins = n/g), with the
    extra constraint p | g so each chip's column shard covers WHOLE
    candidate groups: n/p = nbins · (g/p).  That makes local binning use
    the global slot function unchanged (the shard offset q·n/p is a
    multiple of nbins, so col % nbins is the same slot locally and
    globally) and keeps per-chip group ids in int8 range.

    Two budgets bound the geometry:

      * int8 group ids are PER-CHIP: g/p <= 127, i.e. g <= 127*p;
      * the (block, nbins) candidate buffers stay small:
        nbins = n/g <= ``nbins_cap``, i.e. g >= n/nbins_cap.

    Preferences, in order: enough candidate bins for recall (nbins >=
    8·k_max — floored at the smallest admissible g), then 128-aligned
    bins (128 | nbins), then the largest reduction within
    max(target_reduction, the nbins_cap floor).  Returns 0 when no admissible
    geometry exists (p ∤ n, or no divisor satisfies both budgets).
    """
    if p < 1 or p > 127 or n % p:
        return 0
    g_floor = max(p, -(-n // nbins_cap))        # nbins <= nbins_cap
    g_hi = min(max(target_reduction, g_floor), 127 * p)
    cands = [g for g in range(p, g_hi + 1)
             if g % p == 0 and n % g == 0
             and g // p <= 127 and n // g <= nbins_cap]
    if not cands:
        return 0
    ok = ([g for g in cands if not k_max or (n // g) >= 8 * k_max]
          or [min(cands)])                      # max recall within budget
    aligned = [g for g in ok if (n // g) % 128 == 0]
    return n // (max(aligned) if aligned else max(ok))


def _bcast_rows(x_local: jax.Array, start, block: int,
                axis_name: str = _AXIS) -> jax.Array:
    """Rows [start, start+block) of the row-sharded global tensor,
    replicated to every chip.

    Each global row block lives wholly on one chip (block | n/p, enforced
    by the caller); the owner slices locally, everyone else contributes
    zeros, and one psum replicates the panel — O(block · K) interconnect bytes per
    block instead of the O(n · K) replication the row-sharded layout pays
    up front.  Exact for every dtype (a one-hot sum adds zeros).
    """
    n_local = x_local.shape[0]
    me = jax.lax.axis_index(axis_name)
    owner = start // n_local
    local_start = jnp.where(me == owner, start - owner * n_local, 0)
    sl = jax.lax.dynamic_slice_in_dim(x_local, local_start, block, axis=0)
    if sl.dtype == jnp.bool_:
        contrib = jnp.where(me == owner, sl, False).astype(jnp.int32)
        return jax.lax.psum(contrib, axis_name).astype(jnp.bool_)
    if sl.dtype == jnp.int8:     # sub-word all-reduce support varies by
        contrib = jnp.where(me == owner, sl, 0).astype(jnp.int32)   # backend
        return jax.lax.psum(contrib, axis_name).astype(jnp.int8)
    contrib = jnp.where(me == owner, sl, jnp.zeros((), sl.dtype))
    return jax.lax.psum(contrib, axis_name)


def _merge_candidates(vals: jax.Array, grp_i8: jax.Array, groups_local: int,
                      axis_name: str = _AXIS):
    """Global (block, nbins) candidates from per-chip locals.

    pmax merges the values; the winning group is the LOWEST global group
    among achievers of the max (pmin over achievers) — exactly the
    single-chip first-argmax tie rule, since within a
    chip the local argmax already picked the lowest local group and global
    group ids increase with the chip index.
    """
    me = jax.lax.axis_index(axis_name)
    g_global = grp_i8.astype(jnp.int32) + me * groups_local
    vmax = jax.lax.pmax(vals, axis_name)
    cand = jnp.where(vals == vmax, g_global, jnp.int32(1) << 30)
    return vmax, jax.lax.pmin(cand, axis_name)


def _adjacency_local(keeps, gwins, groups_local: int, nbins: int,
                     axis_name: str = _AXIS) -> jax.Array:
    """(block, n/p) bool adjacency slice from replicated kept candidates —
    the column-sharded mirror of binned_select.adjacency_from_candidates
    (same scatter-free broadcast; this chip materializes only the groups it
    owns, offset me·groups_local in the global group space)."""
    me = jax.lax.axis_index(axis_name)
    block = keeps[0].shape[0]
    gids = me * groups_local + jax.lax.broadcasted_iota(
        jnp.int32, (block, groups_local, nbins), 1)
    adj = None
    for keep, gw in zip(keeps, gwins):
        m = keep[:, None, :] & (gw[:, None, :] == gids)
        adj = m if adj is None else adj | m
    return adj.reshape(block, groups_local * nbins)


# ---------------------------------------------------------------------------
# per-shard column prep (mirror of blocked_affinity.standard_columns /
# generic_columns with the text document frequencies psum'd over the mesh)
# ---------------------------------------------------------------------------

def _unit_xyz(latlon, valid):
    r = jnp.deg2rad(jnp.where(valid[:, None], latlon, 0.0))
    return jnp.stack([jnp.cos(r[:, 0]) * jnp.cos(r[:, 1]),
                      jnp.cos(r[:, 0]) * jnp.sin(r[:, 1]),
                      jnp.sin(r[:, 0])], axis=1)


def _prep_local_modalities(feat_shards: tuple, types: tuple, k_basis: int,
                           tags_dim: int, text_dim: int,
                           axis_name: str = _AXIS) -> list:
    """Per-chip modality descriptors [(metric, tensor, valid, stats, k)].

    ``metric`` is a binned-candidate metric ("dot"/"jaccard"/"chord3"/
    "l1"/"chord") or "username" (dense equality, no kNN).  ``stats`` is the
    (n/p,) row statistic the metric needs (jaccard token sums, chord squared
    norms), else None.  Numerics identical to blocked_affinity's column
    builders; the TF-IDF document frequencies are GLOBAL via psum
    (reference matrix_operations.py:91-110 fits one vectorizer on the whole
    window)."""
    if types[0] == "standard_sparse":
        loc, tim, uid, tags_ids, text_ids, text_cnt, tags_valid = feat_shards
        tags = affinity.counts_from_tokens(tags_ids, None, tags_dim)
        text = affinity.counts_from_tokens(text_ids, text_cnt, text_dim)
        uid = uid.astype(jnp.int32)
    elif types == ("standard",):
        loc, tim, uid, tags, text, tags_valid = feat_shards
        tags = tags.astype(jnp.float32)
        text = text.astype(jnp.float32)
        uid = uid.astype(jnp.int32)
    else:
        return _prep_generic(feat_shards, types, k_basis)

    loc_valid = jnp.all(jnp.isfinite(loc), axis=1)
    tim_valid = (jnp.all(jnp.isfinite(tim), axis=1)
                 & (tim[:, 0] != 0.0) & (tim[:, 1] != 0.0))
    text_valid = jnp.sum(text, axis=1) > 0
    n_docs = jnp.maximum(jax.lax.psum(
        jnp.sum(text_valid.astype(jnp.float32)), axis_name), 1.0)
    df = jax.lax.psum(
        jnp.sum((text > 0) & text_valid[:, None], axis=0).astype(jnp.float32),
        axis_name)
    idf = jnp.log((1.0 + n_docs) / (1.0 + df)) + 1.0
    text = text * idf[None, :]
    text = text / jnp.maximum(jnp.linalg.norm(text, axis=1, keepdims=True),
                              1e-12)
    tags_sums = jnp.sum(tags, axis=1)         # f32 BEFORE the int8 cast
    return [
        ("chord3", _unit_xyz(loc, loc_valid), loc_valid, None, k_basis),
        ("l1", tim, tim_valid, None, 3 * k_basis),
        ("username", uid, uid >= 0, None, 0),
        # int8 tag counts (like standard_columns): exact up to the token
        # cap, half the panel bytes — sims bit-identical
        ("jaccard", bs.pad_features_128(tags.astype(jnp.int8)),
         tags_valid, tags_sums, k_basis),
        ("dot", bs.pad_features_128(text.astype(jnp.bfloat16)),
         text_valid, None, k_basis),
    ]


def _prep_generic(feat_shards: tuple, types: tuple, k_basis: int) -> list:
    """Generic numeric modalities (embedding / location / time / default) —
    the column-sharded mirror of blocked_affinity.generic_columns's kinds."""
    mods = []
    for x, t in zip(feat_shards, types):
        x = x.astype(jnp.float32)
        if t == "location":
            valid = jnp.all(jnp.isfinite(x), axis=1)
            mods.append(("chord3", _unit_xyz(x, valid), valid, None, k_basis))
        elif t == "time":
            valid = (jnp.all(jnp.isfinite(x), axis=1)
                     & (x[:, 0] != 0.0) & (x[:, 1] != 0.0))
            mods.append(("l1", jnp.where(valid[:, None], x, 0.0), valid,
                         None, 3 * k_basis))
        elif t == "embedding":
            # single-bf16 packed like blocked_affinity.generic_columns
            # (round 5, was split_bf16) — the per-shard packing is
            # elementwise per row, so shard tensors equal the single-chip
            # packing's rows exactly (the colsharded fused blocks stay
            # bit-equal to the single-chip binned path)
            fin = jnp.all(jnp.isfinite(x), axis=1)
            safe = jnp.where(fin[:, None], x, 0.0)
            norm = jnp.linalg.norm(safe, axis=1, keepdims=True)
            unit = safe / jnp.maximum(norm, 1e-12)
            mods.append(("dot", ba.bf16_pack(unit),
                         fin & (norm[:, 0] > 0), None, k_basis))
        else:   # default euclidean: k includes self (ref :112-119)
            valid = jnp.all(jnp.isfinite(x), axis=1)
            safe = jnp.where(valid[:, None], x, 0.0)
            packed = ba.bf16_pack(safe)
            # norms = the packed dot's exact self-product |bf16(x)|^2
            # (matching generic_columns — review r5 lineage), keeping the
            # colsharded d2 bit-equal to the single-chip path
            pf = packed.astype(jnp.float32)
            mods.append(("chord", packed, valid, jnp.sum(pf * pf, axis=1),
                         max(1, k_basis) - 1))
    return mods


def _sim_strip(metric: str, t, tr, s_c, s_r):
    """(block, n/p) similarity strip — the same formulas as
    blocked_affinity.fused_rowblock's strip and binned builders."""
    if metric == "dot":
        return jnp.dot(tr, t.T, preferred_element_type=jnp.float32)
    if metric == "jaccard":
        inter = ba._count_dot(tr, t)      # int8 dot path for int8 counts
        return inter / jnp.maximum(
            s_r[:, None] + s_c[None, :] - inter, 1e-9)
    if metric == "chord3":
        return -((tr[:, 0][:, None] - t[:, 0][None, :]) ** 2
                 + (tr[:, 1][:, None] - t[:, 1][None, :]) ** 2
                 + (tr[:, 2][:, None] - t[:, 2][None, :]) ** 2)
    if metric == "l1":
        return -(jnp.abs(tr[:, :1] - t[:, 0][None, :])
                 + jnp.abs(tr[:, 1:2] - t[:, 1][None, :]))
    if metric == "chord":
        d2 = (s_r[:, None] + s_c[None, :]
              - 2.0 * jnp.dot(tr, t.T, preferred_element_type=jnp.float32))
        return -jnp.maximum(d2, 0.0)
    raise ValueError(f"unknown metric {metric}")


def _select_candidates_local(mods: list, start, block: int, n: int,
                             nbins: int, axis_name: str = _AXIS):
    """Globally-merged kNN candidates for rows [start, start+block):
    [(keep, gwin)] per kNN modality (replicated (block, nbins) kept-mask +
    winning GLOBAL group ids), plus the username modality's local
    (uid, valid) pair when present.  The one candidate-selection loop
    shared by the dense assembly (_fused_block_local) and the
    candidate-native fold (_cand_block_local)."""
    n_local = mods[0][1].shape[0]
    groups_local = n_local // nbins
    me = jax.lax.axis_index(axis_name)
    # self-column mask offset: the compare
    # (start_adj + local row) == local column  <=>  global row == global col
    start_adj = start - me * n_local

    cands, user = [], None
    for metric, t, valid, stats, k in mods:
        if metric == "username":
            user = (t, valid)           # k ignored (ref :55-72)
            continue
        k_eff = max(0, min(k, n - 1))
        if k_eff == 0:
            continue
        vr = _bcast_rows(valid, start, block, axis_name)
        tr = _bcast_rows(t, start, block, axis_name)
        sr = (_bcast_rows(stats, start, block, axis_name)
              if stats is not None else None)
        vals, grp = bs.binned_candidates_reference(
            _sim_strip(metric, t, tr, stats, sr), valid, start_adj, nbins)
        vmax, gwin = _merge_candidates(vals, grp, groups_local, axis_name)
        cands.append((bs.budgeted_keep(vmax, vr, k_eff), gwin))
    return cands, user


def _fused_block_local(mods: list, start, block: int, n: int, nbins: int,
                       axis_name: str = _AXIS) -> jax.Array:
    """This chip's (block, n/p) slice of fused adjacency rows
    [start, start+block) — OR of the per-modality kNN adjacencies
    (reference matrix_operations.py:134-141)."""
    n_local = mods[0][1].shape[0]
    groups_local = n_local // nbins
    me = jax.lax.axis_index(axis_name)
    cands, user = _select_candidates_local(mods, start, block, n, nbins,
                                           axis_name)
    if cands:
        fused = _adjacency_local([kp for kp, _ in cands],
                                 [gw for _, gw in cands],
                                 groups_local, nbins, axis_name)
    else:   # every kNN modality skipped (k_eff == 0 everywhere): zero
            # edges, matching the single-chip knn_adjacency_block k=0 case
        fused = jnp.zeros((block, n_local), jnp.bool_)
    if user is not None:
        # username connects ALL same-user rows (ref :55-72)
        uid, valid = user
        tr = _bcast_rows(uid, start, block, axis_name)
        vr = _bcast_rows(valid, start, block, axis_name)
        same = (tr[:, None] == uid[None, :]) & vr[:, None] & valid[None, :]
        not_self = ((start + jnp.arange(block))[:, None]
                    != (me * n_local + jnp.arange(n_local))[None, :])
        fused = fused | (same & not_self)
    return fused


def _cand_block_local(cands: list, user, start, block: int, n_local: int,
                      nbins: int, axis_name: str = _AXIS):
    """This chip's candidate-form slice of the fused adjacency rows: the
    column-sharded mirror of blocked_affinity.candidate_rowblock.

    The merged candidates carry GLOBAL group ids; each chip re-encodes the
    winners that land in ITS column range to LOCAL int8 ids (everything
    else -> -1) and records its global group offset in CandBlock.g0, so
    cand_matvec's products walk only the local groups while the username
    col ids / self-column compare stay globally correct.  The implicit
    matrix equals _fused_block_local's dense slice bit-for-bit (same
    budgeted_keep winners, same uid equality; oracle-tested)."""
    groups_local = n_local // nbins
    me = jax.lax.axis_index(axis_name)
    g0 = (me * groups_local).astype(jnp.int32)
    slabs = []
    for keep, gwin in cands:
        lg = gwin - g0
        local = keep & (lg >= 0) & (lg < groups_local)
        slabs.append(jnp.where(local, lg, -1).astype(jnp.int8))
    if not slabs:               # username-only (or all-k=0) windows
        slabs = [jnp.full((block, nbins), -1, jnp.int8)]
    if user is not None:
        uid, valid = user
        urow = _bcast_rows(jnp.where(valid, uid, -1).astype(jnp.int32),
                           start, block, axis_name)
        uid_rows = urow.reshape(block, 1)
        uid_cols = jnp.where(valid, uid, -2).astype(jnp.int32).reshape(
            groups_local, nbins)
    else:
        uid_rows = None
        uid_cols = jnp.full((groups_local, nbins), -2, jnp.int32)
    return cm.CandBlock(jnp.stack(slabs), uid_rows, uid_cols,
                        jnp.asarray(start, jnp.int32), g0)


# ---------------------------------------------------------------------------
# column-sharded FD shrinks: d-contractions psum over the mesh
# ---------------------------------------------------------------------------

def _shrink_eigh_psum(sketch_l: jax.Array, rows_l: jax.Array, ell: int,
                      axis_name: str = _AXIS, eps: float = 1e-30):
    """Classic FD shrink (ops/fd.shrink) on the column-sharded stack
    [sketch; rows]: the (m2, m2) Gram accumulates shard partials by psum,
    the small eigh runs replicated (identical inputs on every chip), and
    the reconstruction stays local.  Same guarantee, psum summation order.
    """
    hi = jax.lax.Precision.HIGHEST
    s = jnp.concatenate([sketch_l, rows_l.astype(jnp.float32)], axis=0)
    if s.shape[0] <= ell:       # fd.shrink's m <= ell early-out: nothing to
        return s, jnp.zeros((), jnp.float32)   # subtract (lam[ell] OOB-clamps
                                               # under jit, NOT to 0)
    gram = jax.lax.psum(
        jnp.dot(s, s.T, preferred_element_type=jnp.float32, precision=hi),
        axis_name)
    lam, u = jnp.linalg.eigh(gram)
    lam = jnp.maximum(lam[::-1], 0.0)
    u = u[:, ::-1]
    delta = lam[ell]
    scale = jnp.sqrt(jnp.maximum(lam - delta, 0.0) / jnp.maximum(lam, eps))
    shrunk = jnp.dot(u.T * scale[:, None], s,
                     preferred_element_type=jnp.float32, precision=hi)[:ell]
    return shrunk, delta


def _shrink_rr_pair_psum(sketch_l: jax.Array, rows_l: jax.Array, ell: int,
                         axis_name: str = _AXIS, oversample: int = 16,
                         power_iters: int = 1):
    """fd.shrink_rr_pair on column-sharded operands: the iterate v (m2, r)
    and the Rayleigh quotient are replicated; y = S^T v stays sharded
    (d/p, r); every contraction over d — S y, y^T y, the norms — psums its
    shard partials.  Identical math and honest trace-residual accounting;
    only f32 summation order differs.  The inter-application
    orthonormalization is Householder QR of the replicated iterate (local,
    deterministic, so it stays replicated) — the eigh-whiten it replaced
    has condition ~kappa(G)^2 and diverged on long real folds; see
    fd.shrink_rr's stability note."""
    hi = jax.lax.Precision.HIGHEST
    ellr = sketch_l.shape[0]
    m2 = ellr + rows_l.shape[0]
    if m2 <= ell:               # fd.shrink_rr's m <= ell early-out
        return (jnp.concatenate([sketch_l, rows_l.astype(sketch_l.dtype)],
                                axis=0),
                jnp.zeros((), jnp.float32))
    r = min(ell + oversample, m2)
    rows_f = rows_l.astype(jnp.float32)       # fuses into the dots' loads

    def _st(v, precision=hi):                  # S^T v: (d/p, r), local
        return (jnp.dot(sketch_l.T, v[:ellr], precision=precision)
                + jnp.dot(rows_f.T, v[ellr:], precision=precision))

    def _s(y, precision=hi):                   # S y: (m2, r), psum over d
        local = jnp.concatenate([jnp.dot(sketch_l, y, precision=precision),
                                 jnp.dot(rows_f, y, precision=precision)],
                                axis=0)
        return jax.lax.psum(local, axis_name)

    v = jax.random.normal(jax.random.key(7), (m2, r), jnp.float32)
    for _ in range(power_iters):
        # DEFAULT-precision power products, like fd.shrink_rr_pair: they
        # only pick the probe direction (QR re-orthonormalizes exactly);
        # the bound-carrying final y keeps HIGHEST
        v = jnp.linalg.qr(_s(_st(v, None), None))[0]
    y = _st(v)
    h = jax.lax.psum(jnp.dot(y.T, y, precision=hi), axis_name)
    h = 0.5 * (h + h.T)
    _, pvec = jnp.linalg.eigh(h)
    b = jnp.dot(pvec[:, ::-1][:, :ell].T, y.T, precision=hi)   # (ell, d/p)
    sq = jax.lax.psum(jnp.sum(sketch_l * sketch_l)
                      + jnp.sum(jnp.square(rows_f), dtype=jnp.float32),
                      axis_name)
    bsq = jax.lax.psum(jnp.sum(b * b), axis_name)
    delta = jnp.maximum(sq - bsq, 0.0)
    return b.astype(sketch_l.dtype), delta


def _update_colsharded(state: fd.FDState, rows_l: jax.Array, mode: str,
                       axis_name: str = _AXIS) -> fd.FDState:
    """fd.update_stream on a column-sharded (m, n/p) row slice: the same
    absorb granularity as the single-chip fold (eigh chunks ell rows per
    shrink, rr absorbs the whole block — fd.update_stream's block choice),
    so the two folds run the SAME sequence of shrinks and differ only in
    psum summation order."""
    m = rows_l.shape[0]
    ell = state.ell
    chunk = ell if mode == "eigh" else max(ell, min(m, 4096))
    if m <= chunk:
        return _absorb_colsharded(state, rows_l, mode, axis_name)
    n_chunks = -(-m // chunk)
    pad = n_chunks * chunk - m
    if pad:    # zero rows are exact FD no-ops (fd.update_stream's padding)
        rows_l = jnp.concatenate(
            [rows_l, jnp.zeros((pad, rows_l.shape[1]), rows_l.dtype)], axis=0)
    chunks = rows_l.reshape(n_chunks, chunk, rows_l.shape[1])

    def body(st, c):
        return _absorb_colsharded(st, c, mode, axis_name), None

    state, _ = jax.lax.scan(body, state, chunks)
    return state


def _absorb_colsharded(state: fd.FDState, rows_l: jax.Array, mode: str,
                       axis_name: str = _AXIS) -> fd.FDState:
    """fd.update_block on a column-sharded (block, n/p) row slice: the skip
    condition and the Frobenius bookkeeping reduce over the mesh so every
    chip takes the same branch; zero blocks (padding) stay exact no-ops."""
    nonzero = jax.lax.psum(
        jnp.any(rows_l != 0).astype(jnp.float32), axis_name) > 0

    def _absorb(operands):
        sk, rw = operands
        if mode == "rr":
            return _shrink_rr_pair_psum(sk, rw, state.ell, axis_name)
        return _shrink_eigh_psum(sk, rw, state.ell, axis_name)

    def _skip(operands):
        return operands[0], jnp.zeros((), jnp.float32)

    new_sketch, delta = jax.lax.cond(nonzero, _absorb, _skip,
                                     (state.sketch, rows_l))
    sq_inc = jax.lax.psum(
        jnp.sum(jnp.square(rows_l.astype(jnp.float32)), dtype=jnp.float32),
        axis_name)
    return fd.FDState(
        sketch=new_sketch,
        sq_frobenius=state.sq_frobenius + sq_inc,
        shrink_loss=state.shrink_loss + delta,
        count=state.count + jnp.int32(rows_l.shape[0]),
    )


def _shrink_rr_cands_psum(sketch_l: jax.Array, cand, ell: int,
                          axis_name: str = _AXIS, oversample: int = 16,
                          power_iters: int = 1):
    """fd.shrink_rr_cands on a column-sharded implicit stack: the sketch is
    (ellr, n/p) local, the rows live as this chip's candidate slice
    (_cand_block_local), and — exactly like _shrink_rr_pair_psum — every
    contraction over the sharded d axis psums its shard partials while the
    iterate v / Rayleigh quotient stay replicated.  The G-applications run
    one local column group at a time from the int8 slabs (ops/cand_matvec
    with the chip's group offset).  delta keeps
    the exact trace-residual accounting: edges is the psum of per-chip
    integer edge counts, so the telescoped FD bound argument of
    fd.shrink_rr applies unchanged.

    Returns (B' (ell, n/p), delta, edges) — edges GLOBAL (replicated), for
    the caller's sq_frobenius bookkeeping."""
    hi = jax.lax.Precision.HIGHEST
    ellr = sketch_l.shape[0]
    m = cand.block
    m2 = ellr + m
    r = min(ell + oversample, m2)

    def at_rows(v_r):     # probe-precision rows^T v_r: (m, r) -> (d/p, r)
        out_t, _ = cm.matvec_t(cand, v_r.T.astype(jnp.bfloat16))
        return out_t.T                            # local slice — no psum

    def a_rows(y_l):      # probe-precision rows @ y: (d/p, r) -> (m, r)
        return jax.lax.psum(cm.matvec(cand, y_l.astype(jnp.bfloat16)),
                            axis_name)

    v = jax.random.normal(jax.random.key(7), (m2, r), jnp.float32)
    for _ in range(power_iters):
        y0 = jnp.dot(sketch_l.T, v[:ellr]) + at_rows(v[ellr:])
        z = jnp.concatenate(
            [jax.lax.psum(jnp.dot(sketch_l, y0), axis_name), a_rows(y0)],
            axis=0)
        v = jnp.linalg.qr(z)[0]                   # replicated
    v_r = v[ellr:]
    v_hi = v_r.astype(jnp.bfloat16)
    v_lo = (v_r - v_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    out_t, edges_l = cm.matvec_t(
        cand, jnp.concatenate([v_hi.T, v_lo.T], axis=0))
    edges = jax.lax.psum(edges_l, axis_name)
    y = (jnp.dot(sketch_l.T, v[:ellr], precision=hi)
         + (out_t[:r] + out_t[r:]).T)             # (d/p, r) local
    h = jax.lax.psum(jnp.dot(y.T, y, precision=hi), axis_name)
    h = 0.5 * (h + h.T)
    _, p = jnp.linalg.eigh(h)
    b = jnp.dot(p[:, ::-1][:, :ell].T, y.T, precision=hi)   # (ell, d/p)
    sq = jax.lax.psum(jnp.sum(sketch_l * sketch_l), axis_name) + edges
    bsq = jax.lax.psum(jnp.sum(b * b), axis_name)
    delta = jnp.maximum(sq - bsq, 0.0)
    return (b.astype(sketch_l.dtype), delta.astype(jnp.float32),
            edges.astype(jnp.float32))


def _absorb_colsharded_cand(state: fd.FDState, cand,
                            axis_name: str = _AXIS) -> fd.FDState:
    """fd-update on a candidate-form column-sharded block: the skip test
    reduces over the mesh so every chip takes the same branch (a chip's
    LOCAL slab may be empty while the global block has edges); all-empty
    blocks are an exact FD no-op, mirroring shrink_rr_cands's skip."""
    nonzero_l = jnp.any(cand.slabs != jnp.int8(-1))
    if cand.uid_rows is not None:
        nonzero_l = nonzero_l | jnp.any(cand.uid_rows >= 0)
    nonzero = jax.lax.psum(nonzero_l.astype(jnp.float32), axis_name) > 0

    def _absorb(sk):
        return _shrink_rr_cands_psum(sk, cand, state.ell, axis_name)

    def _skip(sk):
        return sk, jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32)

    new_sketch, delta, edges = jax.lax.cond(nonzero, _absorb, _skip,
                                            state.sketch)
    return fd.FDState(
        sketch=new_sketch,
        sq_frobenius=state.sq_frobenius + edges,   # == psum of ||rows||_F^2
        shrink_loss=state.shrink_loss + delta,
        count=state.count + jnp.int32(cand.block),
    )


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _place_row_sharded(feats: tuple, mesh, col_axis: str = _AXIS) -> tuple:
    """device_put each (n, ...) feature array row-sharded over the mesh's
    column axis — the host array splits straight to per-chip shards; the
    full panel never materializes on any single device (the whole point of
    this layout)."""
    out = []
    for x in feats:
        spec = P(col_axis, *([None] * (getattr(x, "ndim", 1) - 1)))
        out.append(jax.device_put(x, NamedSharding(mesh, spec)))
    return tuple(out)


def _mesh_axes(mesh) -> tuple[str, str | None, int, int]:
    """(col_axis, row_axis, pm, pd) from the mesh shape — the mesh IS the
    layout: (p, 1) = pure column sharding over "data"; (pd, pm > 1) = the
    grid (columns over "model", row-block groups over "data")."""
    shape = dict(mesh.shape)
    pm = shape.get("model", 1)
    if pm > 1:
        pd = shape["data"]
        # pd == 1 is pure column sharding over "model": there is nothing to
        # merge, and a degenerate single-group "merge" would spuriously
        # shrink by the smallest retained eigenvalue
        return "model", ("data" if pd > 1 else None), pm, pd
    return "data", None, shape["data"], 1


def _resolve_geometry(n: int, mesh, block: int, k_basis: int,
                      nbins: int | None, check_row_groups: bool = True):
    """Validate the column-sharded sweep geometry and resolve nbins — ONE
    copy shared by every entry point (FD / SVD / spectral / fused-rows) so
    no check can drift between them.  Returns the resolved nbins."""
    col_axis, row_axis, pm, pd = _mesh_axes(mesh)
    del col_axis, row_axis
    if n % pm:
        raise ValueError(f"n={n} must split evenly over {pm} column shards")
    n_local = n // pm
    if n_local % block:
        raise ValueError(
            f"block={block} must divide the per-chip column range n/pm="
            f"{n_local} (pad upstream, as the engine does)")
    if check_row_groups and (n // block) % pd:
        raise ValueError(
            f"row blocks ({n // block}, block={block}) must split evenly "
            f"over the {pd} row groups")
    if nbins is None:
        nbins = default_nbins_colsharded(n, pm, k_max=3 * k_basis)
    if not nbins or n_local % nbins:
        raise ValueError(
            f"no column-sharded bin structure for n={n}, pm={pm} "
            f"(need pm | groups; got nbins={nbins})")
    if n_local // nbins > 127:
        raise ValueError(
            f"nbins={nbins} gives {n_local // nbins} per-chip groups — past "
            "the int8 group-id budget (127); use more bins")
    return nbins


def colsharded_blocked_fd_sketch(feats: tuple, types: tuple, *, ell: int,
                                 block: int, k_basis: int, mesh,
                                 mode: str = "subspace",
                                 tags_dim: int = 2048, text_dim: int = 4096,
                                 nbins: int | None = None,
                                 cand_fold: bool | None = None):
    """FD sketch (ell, n) of the implicit fused adjacency of a HUGE window,
    with the window's FEATURES column-sharded over the mesh.

    ``feats``/``types`` follow the engine's feature-layout encoding
    (("standard_sparse",) | ("standard",) | generic modality types — see
    engine.streaming._fuse_dispatch); arrays are (n, ...) host or device and
    are placed column-sharded here.  Returns (sketch (ell, n) column-sharded
    global array, sq_frobenius, shrink_loss) — the same contract as
    blocked_affinity.blocked_fd_sketch, against which this path is
    adjacency-bit-exact (the fold differs only in psum summation order).

    Mesh shapes: (p, 1) shards columns p ways over "data"; (pd, pm > 1)
    runs the GRID — columns pm ways over "model" (memory), row-block groups
    pd ways over "data" (throughput), with one final merge shrink over the
    gathered per-group sketches (its delta joins the honest loss).

    ``cand_fold``: absorb CANDIDATE-form slices (_cand_block_local +
    _shrink_rr_cands_psum) — each chip's dense (block, n/pm) adjacency
    slice never materializes; the fold's d-contractions run off the int8
    slabs and psum exactly like the dense colsharded fold.  Needs the rr
    shrink (every colsharded modality is binned-eligible by construction —
    this layout has no strip path).  None = the platform's default
    (utils.runtime.platform_paths).  Composes with
    the GRID layout unchanged: per-group sweeps absorb candidates, the
    cross-group merge shrink consumes sketches and stays dense.

    Requirements: pm | n, block | n/pm, pd | (n/block), and a binnable
    structure (default_nbins_colsharded) — this layout has no strip
    fallback since a (block, n) strip is exactly what cannot exist on one
    chip.
    """
    n = feats[0].shape[0]
    col_axis, _, _, _ = _mesh_axes(mesh)
    nbins = _resolve_geometry(n, mesh, block, k_basis, nbins)
    mode = fd.resolve_fold_mode(mode)
    if mode not in ("eigh", "rr"):
        raise ValueError(f"colsharded fold supports 'eigh'/'rr' (via "
                         f"'subspace'), got {mode!r}")
    if cand_fold is None:
        cand_fold = mode == "rr" and platform_paths().cand_fold
    elif cand_fold and mode != "rr":
        raise ValueError("colsharded cand_fold=True needs the rr shrink "
                         "(mode='subspace'/'rr')")
    feats = _place_row_sharded(feats, mesh, col_axis)
    return _colsharded_fd_impl(feats, types=types, ell=ell, block=block,
                               k_basis=k_basis, mesh=mesh, mode=mode,
                               tags_dim=tags_dim, text_dim=text_dim,
                               nbins=nbins, cand_fold=bool(cand_fold))


@functools.partial(jax.jit,
                   static_argnames=("types", "ell", "block", "k_basis",
                                    "mesh", "mode", "tags_dim", "text_dim",
                                    "nbins", "cand_fold"))
def _colsharded_fd_impl(feats: tuple, *, types: tuple, ell: int, block: int,
                        k_basis: int, mesh, mode: str, tags_dim: int,
                        text_dim: int, nbins: int, cand_fold: bool = False):
    n = feats[0].shape[0]
    col_axis, row_axis, pm, pd = _mesh_axes(mesh)
    n_local = n // pm
    starts = jnp.arange(n // block, dtype=jnp.int32) * block

    def body(starts_s, *feat_shards):
        mods = _prep_local_modalities(feat_shards, types, k_basis,
                                      tags_dim, text_dim, col_axis)
        out_dt = jnp.bfloat16 if mode == "rr" else jnp.float32

        def step(state, start):
            if cand_fold:
                cands, user = _select_candidates_local(
                    mods, start, block, n, nbins, col_axis)
                cand = _cand_block_local(cands, user, start, block, n_local,
                                         nbins, col_axis)
                return _absorb_colsharded_cand(state, cand, col_axis), None
            fused = _fused_block_local(mods, start, block, n, nbins,
                                       col_axis)
            return _update_colsharded(state, fused.astype(out_dt), mode,
                                      col_axis), None

        st, _ = jax.lax.scan(step, fd.init(ell, n_local), starts_s)
        sketch, sq, loss = st.sketch, st.sq_frobenius, st.shrink_loss
        if row_axis is not None:
            # merge the pd per-row-group column-sharded sketches: one more
            # psum'd-Gram shrink of the gathered (pd*ell, n/pm) stack (FD
            # mergeability) — identical on every chip, so the result is
            # replicated over the row axis; its delta joins the loss
            stack = jax.lax.all_gather(sketch, row_axis).reshape(-1, n_local)
            if mode == "rr":
                sketch, mdelta = _shrink_rr_pair_psum(
                    stack[:ell], stack[ell:], ell, col_axis)
            else:
                sketch, mdelta = _shrink_eigh_psum(
                    stack[:ell], stack[ell:], ell, col_axis)
            sq = jax.lax.psum(sq, row_axis)
            loss = jax.lax.psum(loss, row_axis) + mdelta
        return (sketch, sq[None], loss[None])

    feat_specs = tuple(P(col_axis, *([None] * (f.ndim - 1))) for f in feats)
    starts_spec = P(row_axis) if row_axis is not None else P()
    sketch, sq, loss = shard_map(
        body, mesh=mesh,
        in_specs=(starts_spec,) + feat_specs,
        out_specs=(P(None, col_axis), P(col_axis), P(col_axis)),
        check_vma=False,
    )(starts, *feats)
    return sketch, sq[0], loss[0]


def colsharded_blocked_svd_reduce(feats: tuple, types: tuple,
                                  key: jax.Array, *, rank: int, block: int,
                                  k_basis: int, mesh, n_iter: int = 2,
                                  oversample: int = 8,
                                  tags_dim: int = 2048,
                                  text_dim: int = 4096,
                                  nbins: int | None = None):
    """Blocked randomized SVD of the implicit fused adjacency with the
    window's FEATURES column-sharded over the mesh — the capacity-layout
    counterpart of parallel.sharded.sharded_blocked_svd_reduce (reference
    TruncatedSVD, matrix_operations.py:143-147).

    Same geometry and fused blocks as colsharded_blocked_fd_sketch (pure
    columns on a (p, 1) mesh, the grid on (pd, pm > 1)).  A·V products
    contract this chip's column slice against its slice of the replicated
    (n, r) panel and psum; Aᵀ·Q partials live column-sharded and gather
    once per sweep for the replicated tall-skinny QR.  Returns (n, rank) =
    U·S replicated (a global array).
    """
    n = feats[0].shape[0]
    col_axis, _, _, _ = _mesh_axes(mesh)
    nbins = _resolve_geometry(n, mesh, block, k_basis, nbins)
    feats = _place_row_sharded(feats, mesh, col_axis)
    return _colsharded_svd_impl(feats, key, types=types, rank=rank,
                                block=block, k_basis=k_basis, mesh=mesh,
                                n_iter=n_iter, oversample=oversample,
                                tags_dim=tags_dim, text_dim=text_dim,
                                nbins=nbins)


@functools.partial(jax.jit,
                   static_argnames=("types", "rank", "block", "k_basis",
                                    "mesh", "n_iter", "oversample",
                                    "tags_dim", "text_dim", "nbins"))
def _colsharded_svd_impl(feats: tuple, key, *, types: tuple, rank: int,
                         block: int, k_basis: int, mesh, n_iter: int,
                         oversample: int, tags_dim: int, text_dim: int,
                         nbins: int):
    n = feats[0].shape[0]
    col_axis, row_axis, pm, pd = _mesh_axes(mesh)
    n_local = n // pm
    r = min(rank + oversample, n)
    starts = jnp.arange(n // block, dtype=jnp.int32) * block

    def body(starts_s, *feat_shards):
        mods = _prep_local_modalities(feat_shards, types, k_basis,
                                      tags_dim, text_dim, col_axis)
        me = jax.lax.axis_index(col_axis)

        def psum_all(x):
            x = jax.lax.psum(x, col_axis)
            return jax.lax.psum(x, row_axis) if row_axis is not None else x

        def sweep(f, init):
            def step(acc, start):
                fused = _fused_block_local(
                    mods, start, block, n, nbins,
                    col_axis).astype(jnp.bfloat16)
                return f(acc, fused, start), None
            acc, _ = jax.lax.scan(step, init, starts_s)
            return acc

        def mul_a(v):          # A @ v: column-slice contractions, psum'd
            v_loc = jax.lax.dynamic_slice_in_dim(v, me * n_local, n_local,
                                                 axis=0)
            def f(acc, fused, start):
                return jax.lax.dynamic_update_slice_in_dim(
                    acc, jnp.dot(fused.astype(jnp.float32), v_loc,
                                 preferred_element_type=jnp.float32),
                    start, axis=0)
            return psum_all(sweep(f, jnp.zeros((n, r))))

        def mul_at(q):         # A^T @ q: naturally column-sharded partials
            def f(acc, fused, start):
                qb = jax.lax.dynamic_slice_in_dim(q, start, block, axis=0)
                return acc + jnp.dot(fused.astype(jnp.float32).T, qb,
                                     preferred_element_type=jnp.float32)
            part = sweep(f, jnp.zeros((n_local, r)))
            if row_axis is not None:      # sum the row groups' block ranges
                part = jax.lax.psum(part, row_axis)
            g = jax.lax.all_gather(part, col_axis)        # (pm, n/pm, r)
            return g.reshape(n, r)

        return ba.randomized_svd_from_products(
            mul_a, mul_at, key, n=n, rank=rank, oversample=oversample,
            n_iter=n_iter)[None]

    feat_specs = tuple(P(col_axis, *([None] * (f.ndim - 1))) for f in feats)
    starts_spec = P(row_axis) if row_axis is not None else P()
    out = shard_map(
        body, mesh=mesh,
        in_specs=(starts_spec,) + feat_specs,
        out_specs=P(col_axis, None, None),
        check_vma=False,
    )(starts, *feats)
    return out[0]


def colsharded_spectral_embedding(feats: tuple, types: tuple,
                                  key: jax.Array, *, k_max: int, block: int,
                                  k_basis: int, mesh, n_iter: int = 6,
                                  oversample: int = 8,
                                  tags_dim: int = 2048,
                                  text_dim: int = 4096,
                                  nbins: int | None = None):
    """Normalized-cuts spectral embedding with the window's FEATURES
    column-sharded over the mesh — the capacity-layout counterpart of
    parallel.sharded.sharded_spectral_embedding (same degrees /
    symmetrized M·V sweeps as ops/blocked_spectral, over column slices).
    Returns (ritz (n, k_max+oversample) basis, eigenvalues), descending
    eigenvalue order, replicated; feed
    ops.blocked_spectral.labels_from_ritz / eigengap_k_from_spectrum.
    """
    n = feats[0].shape[0]
    col_axis, _, _, _ = _mesh_axes(mesh)
    nbins = _resolve_geometry(n, mesh, block, k_basis, nbins)
    feats = _place_row_sharded(feats, mesh, col_axis)
    return _colsharded_spectral_impl(feats, key, types=types, k_max=k_max,
                                     block=block, k_basis=k_basis,
                                     mesh=mesh, n_iter=n_iter,
                                     oversample=oversample,
                                     tags_dim=tags_dim, text_dim=text_dim,
                                     nbins=nbins)


@functools.partial(jax.jit,
                   static_argnames=("types", "k_max", "block", "k_basis",
                                    "mesh", "n_iter", "oversample",
                                    "tags_dim", "text_dim", "nbins"))
def _colsharded_spectral_impl(feats: tuple, key, *, types: tuple,
                              k_max: int, block: int, k_basis: int, mesh,
                              n_iter: int, oversample: int, tags_dim: int,
                              text_dim: int, nbins: int):
    hi = jax.lax.Precision.HIGHEST
    n = feats[0].shape[0]
    col_axis, row_axis, pm, pd = _mesh_axes(mesh)
    n_local = n // pm
    m = min(k_max + oversample, n)
    starts = jnp.arange(n // block, dtype=jnp.int32) * block

    def body(starts_s, *feat_shards):
        mods = _prep_local_modalities(feat_shards, types, k_basis,
                                      tags_dim, text_dim, col_axis)
        me = jax.lax.axis_index(col_axis)

        def psum_rows(x):      # complete a (n, ...) row-assembled partial
            x = jax.lax.psum(x, col_axis)
            return jax.lax.psum(x, row_axis) if row_axis is not None else x

        def gather_cols(x):    # complete a column-sharded (n/pm, ...) part
            if row_axis is not None:
                x = jax.lax.psum(x, row_axis)
            g = jax.lax.all_gather(x, col_axis)
            return g.reshape((n,) + x.shape[1:])

        def sweep(f, init):
            def step(acc, start):
                fused = _fused_block_local(mods, start, block, n, nbins,
                                           col_axis).astype(jnp.float32)
                return f(acc, fused, start), None
            acc, _ = jax.lax.scan(step, init, starts_s)
            return acc

        def f_deg(carry, fused, start):
            rp, cp = carry
            rp = jax.lax.dynamic_update_slice_in_dim(
                rp, jnp.sum(fused, axis=1), start, axis=0)
            return rp, cp + jnp.sum(fused, axis=0)

        rp, cp = sweep(f_deg, (jnp.zeros(n), jnp.zeros(n_local)))
        deg = 0.5 * (psum_rows(rp) + gather_cols(cp))
        inv_sqrt = jnp.where(deg > 0,
                             jax.lax.rsqrt(jnp.maximum(deg, 1e-12)), 0.0)

        def sym_matmul(v):     # v (n, m) replicated
            v_loc = jax.lax.dynamic_slice_in_dim(v, me * n_local, n_local,
                                                 axis=0)
            def f(carry, fused, start):
                av, atv = carry
                vb = jax.lax.dynamic_slice_in_dim(v, start, block, axis=0)
                av = jax.lax.dynamic_update_slice_in_dim(
                    av, jnp.dot(fused, v_loc, precision=hi), start, axis=0)
                return av, atv + jnp.dot(fused.T, vb, precision=hi)
            av, atv = sweep(f, (jnp.zeros((n, m)), jnp.zeros((n_local, m))))
            return 0.5 * (psum_rows(av) + gather_cols(atv))

        from mused_tpu.ops.blocked_spectral import ritz_from_products
        ritz, lam = ritz_from_products(sym_matmul, inv_sqrt, key, n=n, m=m,
                                       n_iter=n_iter)
        return ritz[None], lam[None]

    feat_specs = tuple(P(col_axis, *([None] * (f.ndim - 1))) for f in feats)
    starts_spec = P(row_axis) if row_axis is not None else P()
    ritz, lam = shard_map(
        body, mesh=mesh,
        in_specs=(starts_spec,) + feat_specs,
        out_specs=(P(col_axis, None, None), P(col_axis, None)),
        check_vma=False,
    )(starts, *feats)
    return ritz[0], lam[0]


def colsharded_fused_rows(feats: tuple, types: tuple, *, start: int,
                          block: int, k_basis: int, mesh,
                          tags_dim: int = 2048, text_dim: int = 4096,
                          nbins: int | None = None) -> jax.Array:
    """(block, n) fused adjacency rows [start, start+block) assembled from
    the column-sharded sweep — the parity/debug surface (tested bit-equal
    to blocked_affinity.fused_rowblock's binned path).

    ``start`` must be a multiple of ``block`` (every internal sweep start
    is): _bcast_rows assumes each row block lives WHOLLY on one chip, and
    a straddling range would silently return the owner's clamped slice
    (review r5 finding)."""
    n = feats[0].shape[0]
    if start % block:
        raise ValueError(
            f"start={start} must be a multiple of block={block}: a row "
            "range straddling a shard boundary has no single owner chip")
    col_axis, _, pm, _ = _mesh_axes(mesh)
    nbins = _resolve_geometry(n, mesh, block, k_basis, nbins,
                              check_row_groups=False)
    feats = _place_row_sharded(feats, mesh, col_axis)

    def body(*feat_shards):
        mods = _prep_local_modalities(feat_shards, types, k_basis,
                                      tags_dim, text_dim, col_axis)
        return _fused_block_local(mods, jnp.int32(start), block, n, nbins,
                                  col_axis)

    in_specs = tuple(P(col_axis, *([None] * (f.ndim - 1))) for f in feats)
    return shard_map(body, mesh=mesh, in_specs=in_specs,
                     out_specs=P(None, col_axis), check_vma=False)(*feats)
