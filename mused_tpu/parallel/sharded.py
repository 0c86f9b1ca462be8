"""SPMD sharded window step — the framework's multi-chip "training step".

Row-parallel decomposition of the streaming window pipeline (SURVEY.md §5.7:
the O(n^2) affinity construction is the moral analog of blockwise attention —
each chip owns a row block, column data is gathered/rotated over the
interconnect):

  per chip (row shard of m = n/p window rows):
    all_gather column features (small: coords, times, ids)  ......... link
    rectangular (m, n) similarity blocks -> top_k -> adjacency shard  matmul
    global TF-IDF document frequencies ....................... psum   link
    OR-fuse modality shards .................................. elementwise
    local FD sketch of the fused row shard ................... matmul+eigh
    sketch merge ............................... all_gather/ring  link
    KMeans on the replicated reduced matrix (n x ell, tiny)

Feature-hash ("model") axis sharding: hashed tag/text feature columns can be
sharded too — the Jaccard/cosine contractions then psum over "model" — giving
the TP analog.  This module implements the "data"-axis shard_map explicitly;
the "model" axis is exercised through GSPMD sharding constraints in
``__graft_entry__.dryrun_multichip``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mused_tpu.ops import affinity, fd, kmeans
from mused_tpu.parallel import sketch_merge

shard_map = jax.shard_map


# rectangular kNN helper shared with the single-chip and blocked paths
knn_adjacency_block = affinity.knn_adjacency_block


def _row_shard_fused_adjacency(loc_s, time_s, uid_s, tags_s, text_s,
                               k_basis: int, axis_name: str = "data",
                               tags_valid_s=None, tags_f=None, text_f=None):
    """Device-local body: fused (m, n) adjacency shard from feature shards.

    Every collective is explicit: all_gather for column features, psum for
    global TF-IDF document frequencies.  Sparse-token callers pass the
    PRE-GATHERED dense panels (tags_f/text_f) built from all_gathered
    token ids — gathering the densified (m, dim) f32 panels here would
    cost ~dim/T x the interconnect bytes (review r5 finding).
    """
    m = loc_s.shape[0]
    p_idx = jax.lax.axis_index(axis_name)
    row_offset = p_idx * m

    def gather(x):
        g = jax.lax.all_gather(x, axis_name)          # (p, m, ...)
        return g.reshape((-1,) + g.shape[2:])          # (n, ...)

    loc_f, time_f, uid_f = gather(loc_s), gather(time_s), gather(uid_s)
    if tags_f is None:
        tags_f = gather(tags_s)
    if text_f is None:
        text_f = gather(text_s)

    mats = []
    # location: haversine row-block vs all columns (ref matrix_operations.py:23-30)
    lv_r = jnp.all(jnp.isfinite(loc_s), axis=1)
    lv_c = jnp.all(jnp.isfinite(loc_f), axis=1)
    sim = -affinity.haversine_block(jnp.where(lv_r[:, None], loc_s, 0.0),
                                    jnp.where(lv_c[:, None], loc_f, 0.0))
    mats.append(knn_adjacency_block(sim, lv_r, lv_c, k_basis, row_offset))

    # time (ref :32-53)
    tv_r = (jnp.all(jnp.isfinite(time_s), axis=1)
            & (time_s[:, 0] != 0.0) & (time_s[:, 1] != 0.0))
    tv_c = (jnp.all(jnp.isfinite(time_f), axis=1)
            & (time_f[:, 0] != 0.0) & (time_f[:, 1] != 0.0))
    sim = -(jnp.abs(time_s[:, :1] - time_f[:, 0][None, :])
            + jnp.abs(time_s[:, 1:2] - time_f[:, 1][None, :]))
    mats.append(knn_adjacency_block(sim, tv_r, tv_c, 3 * k_basis, row_offset))

    # username equality (ref :55-72)
    uv_r, uv_c = uid_s >= 0, uid_f >= 0
    same = (uid_s[:, None] == uid_f[None, :]) & uv_r[:, None] & uv_c[None, :]
    not_self = (row_offset + jnp.arange(m))[:, None] != jnp.arange(uid_f.shape[0])[None, :]
    mats.append((same & not_self).astype(jnp.float32))

    # tags Jaccard (ref :74-89); validity from the raw-cell quirk when the
    # featurizer provides it (see affinity.tags_adjacency)
    if tags_valid_s is not None:
        gv_r = tags_valid_s
        gv_c = gather(tags_valid_s)
    else:
        gv_r = jnp.sum(tags_s, axis=1) > 0
        gv_c = jnp.sum(tags_f, axis=1) > 0
    inter = jnp.dot(tags_s, tags_f.T, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    sizes_r, sizes_c = jnp.sum(tags_s, axis=1), jnp.sum(tags_f, axis=1)
    union = sizes_r[:, None] + sizes_c[None, :] - inter
    sim = jnp.where(union > 0, inter / jnp.maximum(union, 1e-9), 0.0)
    mats.append(knn_adjacency_block(sim, gv_r, gv_c, k_basis, row_offset))

    # text TF-IDF cosine with GLOBAL document frequencies via psum (ref :91-110)
    xv_r = jnp.sum(text_s, axis=1) > 0
    n_docs = jax.lax.psum(jnp.sum(xv_r.astype(jnp.float32)), axis_name)
    df = jax.lax.psum(jnp.sum((text_s > 0) & xv_r[:, None], axis=0)
                      .astype(jnp.float32), axis_name)
    idf = jnp.log((1.0 + jnp.maximum(n_docs, 1.0)) / (1.0 + df)) + 1.0
    x_r = text_s * idf[None, :]
    x_r = x_r / jnp.maximum(jnp.linalg.norm(x_r, axis=1, keepdims=True), 1e-12)
    x_c = text_f * idf[None, :]
    x_c = x_c / jnp.maximum(jnp.linalg.norm(x_c, axis=1, keepdims=True), 1e-12)
    xv_c = jnp.sum(text_f, axis=1) > 0
    sim = jnp.dot(x_r, x_c.T, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    mats.append(knn_adjacency_block(sim, xv_r, xv_c, k_basis, row_offset))

    return affinity.fuse(mats)      # (m, n) fused shard


def _gather_rows(x, axis_name: str = "data"):
    """(m, ...) shard -> (n, ...) replicated row concatenation."""
    g = jax.lax.all_gather(x, axis_name)
    return g.reshape((-1,) + g.shape[2:])


def _generic_fused_shard(mats_s, types, k_basis: int,
                         axis_name: str = "data"):
    """Fused (m, n) adjacency shard for numeric modalities — the sharded
    mirror of engine.streaming._fuse_generic (embedding / location / time /
    default kNN conventions identical to ops.affinity)."""
    m = mats_s[0].shape[0]
    row_offset = jax.lax.axis_index(axis_name) * m
    out = []
    for x_s, t in zip(mats_s, types):
        x_f = _gather_rows(x_s, axis_name)
        if t == "embedding":
            def prep(x):
                fin = jnp.all(jnp.isfinite(x), axis=1)
                safe = jnp.where(fin[:, None], x, 0.0)
                norm = jnp.linalg.norm(safe, axis=1, keepdims=True)
                return safe / jnp.maximum(norm, 1e-12), fin & (norm[:, 0] > 0)
            xr, v_r = prep(x_s)
            xc, v_c = prep(x_f)
            sim = jnp.dot(xr, xc.T, preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
            out.append(knn_adjacency_block(sim, v_r, v_c, k_basis, row_offset))
        elif t == "location":
            v_r = jnp.all(jnp.isfinite(x_s), axis=1)
            v_c = jnp.all(jnp.isfinite(x_f), axis=1)
            sim = -affinity.haversine_block(
                jnp.where(v_r[:, None], x_s, 0.0),
                jnp.where(v_c[:, None], x_f, 0.0))
            out.append(knn_adjacency_block(sim, v_r, v_c, k_basis, row_offset))
        elif t == "time":
            def tvalid(x):
                return (jnp.all(jnp.isfinite(x), axis=1)
                        & (x[:, 0] != 0.0) & (x[:, 1] != 0.0))
            v_r, v_c = tvalid(x_s), tvalid(x_f)
            xs = jnp.where(v_r[:, None], x_s, 0.0)
            xf = jnp.where(v_c[:, None], x_f, 0.0)
            sim = -(jnp.abs(xs[:, :1] - xf[:, 0][None, :])
                    + jnp.abs(xs[:, 1:2] - xf[:, 1][None, :]))
            out.append(knn_adjacency_block(sim, v_r, v_c, 3 * k_basis,
                                           row_offset))
        else:   # default euclidean: k_basis includes self (ref :112-119)
            v_r = jnp.all(jnp.isfinite(x_s), axis=1)
            v_c = jnp.all(jnp.isfinite(x_f), axis=1)
            safe_r = jnp.where(v_r[:, None], x_s, 0.0)
            safe_c = jnp.where(v_c[:, None], x_f, 0.0)
            d2 = (jnp.sum(safe_r * safe_r, axis=1)[:, None]
                  + jnp.sum(safe_c * safe_c, axis=1)[None, :]
                  - 2.0 * jnp.dot(safe_r, safe_c.T,
                                  preferred_element_type=jnp.float32,
                                  precision=jax.lax.Precision.HIGHEST))
            out.append(knn_adjacency_block(-jnp.maximum(d2, 0.0), v_r, v_c,
                                           max(1, k_basis) - 1, row_offset))
    return affinity.fuse(out)


def _features_to_fused_shard(feat_shards, types, k_basis: int, tags_dim: int,
                             text_dim: int, axis_name: str = "data"):
    """Dispatch a tuple of per-chip feature shards to the right fused-shard
    builder.  ``types`` mirrors engine.streaming._types_for's encoding:
    ("standard_sparse",) | ("standard",) | a generic modality-type tuple
    (hash widths always come from the tags_dim/text_dim kwargs)."""
    if types[0] == "standard_sparse":
        loc, tim, uid, tags_ids, text_ids, text_cnt, tags_valid = feat_shards
        # gather the SPARSE token tensors (int16 ids / uint8 counts) over
        # the interconnect and densify on BOTH sides of the gather: densify-then-gather
        # shipped the (m, tags_dim/text_dim) f32 panels — ~dim/T x the
        # bytes — for a bitwise-identical result
        tags = affinity.counts_from_tokens(tags_ids, None, tags_dim)
        text = affinity.counts_from_tokens(text_ids, text_cnt, text_dim)
        tags_f = affinity.counts_from_tokens(
            _gather_rows(tags_ids, axis_name), None, tags_dim)
        text_f = affinity.counts_from_tokens(
            _gather_rows(text_ids, axis_name),
            _gather_rows(text_cnt, axis_name), text_dim)
        return _row_shard_fused_adjacency(loc, tim, uid.astype(jnp.int32),
                                          tags, text, k_basis, axis_name,
                                          tags_valid, tags_f=tags_f,
                                          text_f=text_f)
    if types == ("standard",):
        loc, tim, uid, tags, text, tags_valid = feat_shards
        return _row_shard_fused_adjacency(
            loc, tim, uid.astype(jnp.int32), tags.astype(jnp.float32),
            text.astype(jnp.float32), k_basis, axis_name, tags_valid)
    return _generic_fused_shard(feat_shards, types, k_basis, axis_name)


def _dist_svd_reduce(fused_s, key, reduced_dim: int, *, n_iter: int = 4,
                     oversample: int = 10, axis_name: str = "data"):
    """Distributed reduction.svd_reduce: randomized truncated SVD of the
    row-sharded (m, n) fused adjacency.

    Deliberately mirrors ops/reduction.randomized_svd (n_iter=4,
    oversample=10, B = Q^T A small-SVD ordering) — NOT
    blocked_affinity.randomized_svd_from_products (n_iter=2, oversample=8,
    A^T Q variant): the parity contract here is bit-level agreement with
    the single-chip DENSE engine step, which uses reduction's constants.
    A change to reduction.randomized_svd must land here too.

    Collective pattern: the sketch Y = A @ Omega is computed shard-locally
    (Omega is replicated — same key everywhere), gathered to (n, k) for the
    tall-skinny QR (tiny: k = rank+oversample), and A^T-products psum over
    the data axis.  Per-chip redundant QR work is O(n k^2) — negligible next
    to the O(n^2/p (d_feat+k)) shard work.  Matches single-chip svd_reduce
    semantics: r = min(reduced_dim, d-1) components, zero-padded back.
    """
    m, n = fused_s.shape
    r = min(reduced_dim, n - 1)
    k = min(r + oversample, n)
    omega = jax.random.normal(key, (n, k), jnp.float32)
    p_idx = jax.lax.axis_index(axis_name)

    def my_rows(full):               # (n, k) replicated -> this chip's (m, k)
        return jax.lax.dynamic_slice_in_dim(full, p_idx * m, m, axis=0)

    y = _gather_rows(jnp.dot(fused_s, omega,
                             preferred_element_type=jnp.float32), axis_name)
    q, _ = jnp.linalg.qr(y)

    def power_step(q, _):
        z = jax.lax.psum(jnp.dot(fused_s.T, my_rows(q),
                                 preferred_element_type=jnp.float32),
                         axis_name)
        z, _ = jnp.linalg.qr(z)
        y = _gather_rows(jnp.dot(fused_s, z,
                                 preferred_element_type=jnp.float32),
                         axis_name)
        q, _ = jnp.linalg.qr(y)
        return q, None

    q, _ = jax.lax.scan(power_step, q, None, length=n_iter)
    b = jax.lax.psum(jnp.dot(my_rows(q).T, fused_s,
                             preferred_element_type=jnp.float32), axis_name)
    ub, s, _ = jnp.linalg.svd(b, full_matrices=False)     # (k, n) small
    out = (q @ ub)[:, :r] * s[None, :r]
    if r < reduced_dim:
        out = jnp.concatenate(
            [out, jnp.zeros((n, reduced_dim - r), out.dtype)], axis=1)
    return out                        # (n, reduced_dim) replicated


def _feat_specs(feats):
    return tuple(P(*(("data",) + (None,) * (f.ndim - 1))) for f in feats)


def _engine_step_core(swfd_state, minibatch_state, feats: tuple,
                      n_clusters, key, *, approach: str, k_basis: int,
                      reduced_dim: int, k_max: int, window: int,
                      fd_shrink: str, types: tuple, tags_dim: int,
                      text_dim: int, mesh, topology: str = "allgather",
                      k_source: str = "given", need_reduced: bool = True,
                      eigengap_theta: float = 0.15,
                      background: bool = False):
    """Traceable body shared by ``sharded_engine_step`` (one jitted window)
    and ``sharded_scanned_steps`` (a ``lax.scan`` of W windows).

    ``k_source="eigengap"``: ignore ``n_clusters`` and estimate the cluster
    count from the replicated reduced matrix's spectrum on device
    (ops/reduction.eigengap_k) — same semantics as the single-chip step."""
    from mused_tpu.ops import swfd as swfd_mod

    def body(*feat_shards):
        fused_s = _features_to_fused_shard(feat_shards, types, k_basis,
                                           tags_dim, text_dim)
        r_norm = sketch_merge.global_max_row_norm(fused_s)
        if approach == "SWFDMC":
            ell = swfd_state.blocks.shape[1]
            # per-shard whole-window-share summary = a fold; "subspace"
            # resolves to the rr shrink exactly like the single-chip step
            blk, sq_fro, loss = fd.fold_sketch(
                fused_s, ell=ell, mode=fd.resolve_fold_mode(fd_shrink))
            if topology == "ring":
                merged = sketch_merge.ring_merge(blk)
            else:
                merged = sketch_merge.allgather_merge(blk, ell)
            # honest error accounting across chips: per-shard losses sum, and
            # the merge shrink adds its own (unknown here) delta <= sq_fro/ell
            # — swfd.query caps with that bound anyway
            aux2 = jax.lax.psum(jnp.stack([sq_fro, loss]), "data")
            return (merged[None], aux2[None],
                    jnp.reshape(r_norm, (1,)), fused_s)
        if approach == "sSpectral" and not need_reduced:
            # labels come from spectral_clustering(fused) below; the SVD
            # reduction feeds only the verbose oracle (engine passes
            # need_reduced=True then) and can't be DCE'd as a jit output
            reduced = jnp.zeros((fused_s.shape[1], 0), jnp.float32)
        else:
            reduced = _dist_svd_reduce(fused_s, key, reduced_dim)
        return (reduced[None], jnp.zeros((1, 2), jnp.float32),
                jnp.reshape(r_norm, (1,)), fused_s)

    out, aux, r_norm, fused = shard_map(
        body, mesh=mesh,
        in_specs=_feat_specs(feats),
        out_specs=(P("data", None, None), P("data", None), P("data"),
                   P("data", None)),
        check_vma=False,
    )(*feats)
    r_norm = r_norm[0]

    state = swfd_state
    if approach == "SWFDMC":
        n = fused.shape[0]
        state = swfd_mod.absorb_summary(swfd_state, out[0], jnp.int32(n),
                                        aux[0, 0], aux[0, 1])
        sketch, _, _, _ = swfd_mod.query(state, window=window,
                                         sketch_dim=reduced_dim)
        reduced = sketch.T          # rows index datapoints (ref main.py:73-76)
    else:
        reduced = out[0]

    if k_source == "eigengap" and approach != "sSpectral":
        from mused_tpu.ops import reduction
        # `reduced` is replicated after the merge/distributed SVD, so the
        # estimate is identical on every chip — no collective needed
        n_clusters = reduction.eigengap_k(reduced, k_max=k_max,
                                          theta=eigengap_theta)

    new_mb = minibatch_state
    if approach == "sSpectral":
        from mused_tpu.ops import spectral
        # under "eigengap" the count comes from the normalized-affinity
        # spectrum inside spectral_clustering (same rule as the blocked/
        # sharded huge-window paths), not the reduced energies
        labels = spectral.spectral_clustering(fused, n_clusters, key,
                                              k_max=k_max, k_source=k_source,
                                              background=background)
    elif approach == "sSVDMC_mini":
        new_mb, labels = kmeans.minibatch_step(minibatch_state, reduced, key)
    elif approach in ("DBSCAN_incr", "DBSCAN_centr"):
        labels = jnp.zeros((reduced.shape[0],), jnp.int32)  # host glue
    else:
        from mused_tpu.parallel.kmeans_sharded import kmeans_sharded
        labels, _ = kmeans_sharded(reduced, n_clusters, key, k_max=k_max,
                                   mesh=mesh)
        if background:
            # reduced/labels are replicated — the bucket is chip-identical
            labels = kmeans.mark_background(reduced, labels, k_max=k_max)
    return state, new_mb, reduced, labels, r_norm


_STEP_STATICS = ("approach", "k_basis", "reduced_dim", "k_max", "window",
                 "fd_shrink", "types", "tags_dim", "text_dim", "mesh",
                 "topology", "k_source", "need_reduced", "eigengap_theta",
                 "background")


@functools.partial(jax.jit, static_argnames=_STEP_STATICS,
                   donate_argnames=("swfd_state",))
def sharded_engine_step(swfd_state, minibatch_state, feats: tuple,
                        n_clusters, key, *, approach: str, k_basis: int,
                        reduced_dim: int, k_max: int, window: int,
                        fd_shrink: str, types: tuple, tags_dim: int,
                        text_dim: int, mesh, topology: str = "allgather",
                        k_source: str = "given", need_reduced: bool = True,
                        eigengap_theta: float = 0.15,
                        background: bool = False):
    """Multi-chip mirror of engine.streaming._window_step — the full
    per-window device step with every collective riding the mesh "data" axis.

    Pipeline per chip (SURVEY.md §7.2 step 7):
      fused (m, n) adjacency shard (all_gather'd column features, psum'd IDF)
      -> SWFDMC: local FD of the shard -> sketch merge -> replicated
         SWFD ring absorb/query (tiny ell x n state)
         else: distributed randomized SVD (psum'd A^T-products)
      -> row-sharded KMeans (psum'd centroid accumulation) | replicated
         MiniBatch step | host-glued density clustering on the reduced rows.

    Returns (new_swfd, new_minibatch, reduced (n, dim), labels (n,), R) with
    the same contract as the single-chip step (R = pmax'd max squared row
    norm, reference main.py:61).
    """
    return _engine_step_core(
        swfd_state, minibatch_state, feats, n_clusters, key,
        approach=approach, k_basis=k_basis, reduced_dim=reduced_dim,
        k_max=k_max, window=window, fd_shrink=fd_shrink, types=types,
        tags_dim=tags_dim, text_dim=text_dim, mesh=mesh, topology=topology,
        k_source=k_source, need_reduced=need_reduced,
        eigengap_theta=eigengap_theta, background=background)


@functools.partial(jax.jit, static_argnames=_STEP_STATICS,
                   donate_argnames=("swfd_state",))
def sharded_scanned_steps(swfd_state, minibatch_state, feats_batch: tuple,
                          n_clusters, keys, *, approach: str, k_basis: int,
                          reduced_dim: int, k_max: int, window: int,
                          fd_shrink: str, types: tuple, tags_dim: int,
                          text_dim: int, mesh, topology: str = "allgather",
                          k_source: str = "given",
                          need_reduced: bool = False,
                          eigengap_theta: float = 0.15,
                          background: bool = False):
    """W tumbling windows in ONE SPMD dispatch: ``lax.scan`` threads the
    SWFD ring + MiniBatch state through the per-window sharded step — the
    multi-chip mirror of engine._scanned_window_steps, composing
    ``windows_per_batch`` with ``data_shards``.  ``feats_batch`` tensors are
    stacked (W, n, ...); returns (new_swfd, new_minibatch, labels (W, n),
    r_norms (W,)) with labels replicated like the per-window step's.  Numerically
    identical to W per-window sharded dispatches (the scan body IS the
    per-window step)."""

    def body(carry, per_window):
        sw, mb = carry
        feats, k, key = per_window
        sw, mb, _, labels, r_norm = _engine_step_core(
            sw, mb, feats, k, key, approach=approach, k_basis=k_basis,
            reduced_dim=reduced_dim, k_max=k_max, window=window,
            fd_shrink=fd_shrink, types=types, tags_dim=tags_dim,
            text_dim=text_dim, mesh=mesh, topology=topology,
            k_source=k_source, need_reduced=need_reduced,
            eigengap_theta=eigengap_theta, background=background)
        return (sw, mb), (labels, r_norm)

    (sw, mb), (labels, r_norms) = jax.lax.scan(
        body, (swfd_state, minibatch_state), (feats_batch, n_clusters, keys))
    return sw, mb, labels, r_norms


@functools.partial(jax.jit,
                   static_argnames=("k_basis", "reduced_dim", "k_max", "mesh"))
def sharded_window_step(location, times, user_ids, tags, text, n_clusters,
                        key, *, k_basis: int, reduced_dim: int, k_max: int,
                        mesh):
    """Full multi-chip window step: sharded affinity -> fused shard -> local
    FD -> sketch merge -> KMeans.  Inputs are (n, ...) arrays; the "data"
    axis of the mesh shards rows.  Returns (labels (n,), reduced (n, dim))."""

    def body(loc_s, time_s, uid_s, tags_s, text_s):
        fused_s = _row_shard_fused_adjacency(loc_s, time_s, uid_s, tags_s,
                                             text_s, k_basis)
        st = fd.update_stream(fd.init(reduced_dim, fused_s.shape[1]), fused_s)
        merged = sketch_merge.allgather_merge(st.sketch, reduced_dim)
        return fused_s, merged[None]

    fused, merged = shard_map(
        body, mesh=mesh,
        in_specs=(P("data", None), P("data", None), P("data"),
                  P("data", None), P("data", None)),
        out_specs=(P("data", None), P("data", None, None)),
        check_vma=False,
    )(location, times, user_ids, tags, text)

    sketch = merged[0]                     # (reduced_dim, n) replicated
    reduced = sketch.T                     # rows index datapoints (ref main.py:73-76)
    # row-sharded SPMD Lloyd (psum'd centroid accumulation)
    from mused_tpu.parallel.kmeans_sharded import kmeans_sharded
    labels, _ = kmeans_sharded(reduced, n_clusters, key, k_max=k_max,
                               mesh=mesh)
    return labels, reduced


# ---------------------------------------------------------------------------
# sharded huge-window path: rematerialized row blocks, one chip per row range
# ---------------------------------------------------------------------------


def _check_row_blocks(n: int, block: int, p: int) -> None:
    """Row-sharded sweep geometry — ONE copy shared by the FD / SVD /
    spectral wrappers (each chip folds a contiguous range of row blocks)."""
    if n % block:
        raise ValueError(f"block={block} must divide n={n} (pad upstream)")
    if (n // block) % p:
        raise ValueError(
            f"row blocks ({n // block}) must split evenly over "
            f"data_shards={p}")


def sharded_blocked_fd_sketch(cols, *, ell: int, block: int, k_basis: int,
                              mesh, topology: str = "allgather",
                              mode: str = "subspace",
                              approx_knn: bool = False,
                              select: str = "strip", nbins: int = 0,
                              cand_fold: bool | None = None):
    """Multi-chip FD sketch of the implicit fused adjacency of a HUGE window.

    The single-chip huge-window path (ops/blocked_affinity.blocked_fd_sketch,
    BASELINE.md #3) sweeps rematerialized (block, n) adjacency row blocks
    sequentially; here the sweep is row-sharded over the mesh "data" axis:
    column feature tensors are replicated (they are the small per-row
    features, not the O(n^2) matrix), each chip folds a local FD sketch over
    its contiguous range of row blocks, and the per-chip sketches merge over
    the interconnect (allgather or ring — FD mergeability, SURVEY.md §2.8).  Scaling is
    embarrassing up to the merge: p chips sweep p-fold fewer blocks each.

    Returns (sketch (ell, n), sq_frobenius, shrink_loss) with the same
    shapes as blocked_fd_sketch.  ``shrink_loss`` is the psum of the
    per-chip SWEEP losses only — the merge shrink's own delta is NOT
    included (sketch_merge discards it), same documented omission as the
    dense SWFDMC branch; swfd.query's error cap uses the sq_fro/ell bound
    regardless, so the omission understates a diagnostic, never the
    guarantee.  Requires block | n and p | (n // block).
    """
    n = cols.n
    p = mesh.shape["data"]
    _check_row_blocks(n, block, p)
    # "subspace" at fold scale routes to the Rayleigh-Ritz shrink, matching
    # the single-chip blocked fold (see fd.resolve_fold_mode)
    mode = fd.resolve_fold_mode(mode)
    # candidate-native fold (ops/cand_matvec): same gating as the
    # single-chip path — per-shard sweeps are independent, so each chip
    # absorbs its own candidate blocks; only the final merge communicates
    from mused_tpu.ops import blocked_affinity as ba
    from mused_tpu.utils.runtime import platform_paths
    eligible = (mode == "rr" and select == "binned"
                and ba.cand_fold_supported(cols.kinds, cols.tensors, nbins,
                                           n))
    if cand_fold is None:
        cand_fold = eligible and platform_paths().cand_fold
    elif cand_fold and not eligible:
        raise ValueError(
            "cand_fold=True needs the rr shrink, select='binned', "
            "block | n, and every modality binned-eligible "
            "(blocked_affinity.cand_fold_supported)")
    return _sharded_blocked_fd_impl(
        cols.tensors, cols.valids, cols.idf, kinds=cols.kinds, ell=ell,
        block=block, k_basis=k_basis, mesh=mesh, topology=topology,
        mode=mode, approx_knn=approx_knn, select=select, nbins=nbins,
        cand_fold=cand_fold)


@functools.partial(jax.jit,
                   static_argnames=("kinds", "ell", "block", "k_basis",
                                    "mesh", "topology", "mode",
                                    "approx_knn", "select", "nbins",
                                    "cand_fold"))
def _sharded_blocked_fd_impl(tensors, valids, idf, *, kinds, ell: int,
                             block: int, k_basis: int, mesh,
                             topology: str, mode: str = "subspace",
                             approx_knn: bool = False,
                             select: str = "strip", nbins: int = 0,
                             cand_fold: bool = False):
    from mused_tpu.ops import blocked_affinity as ba
    t0 = tensors[0]
    n = (t0[0] if isinstance(t0, tuple) else t0).shape[0]
    starts = jnp.arange(n // block, dtype=jnp.int32) * block

    def body(tensors, valids, idf, starts_s):
        cols = ba.Columns(kinds=kinds, tensors=tensors, valids=valids,
                          idf=idf)

        def step(state, start):
            if cand_fold:
                # candidate-native absorb (ops/cand_matvec)
                cand = ba.candidate_rowblock(cols, start, block, k_basis,
                                             nbins)
                b, delta, edges = fd.shrink_rr_cands(state.sketch, cand, ell)
                return fd.FDState(
                    sketch=b,
                    sq_frobenius=state.sq_frobenius + edges,
                    shrink_loss=state.shrink_loss + delta,
                    count=state.count + jnp.int32(block)), None
            # bf16 0/1 edges for rr folds (see blocked_affinity): the
            # split-operand absorb re-reads the block; half the bytes
            out_dt = jnp.bfloat16 if mode == "rr" else jnp.float32
            fused = ba.fused_rowblock(cols, start, block, k_basis,
                                      approx_knn, select, nbins, out_dt)
            return fd.update_stream(state, fused, mode=mode), None

        st, _ = jax.lax.scan(step, fd.init(ell, n), starts_s)
        sq = jax.lax.psum(st.sq_frobenius, "data")
        loss = jax.lax.psum(st.shrink_loss, "data")
        if topology == "ring":
            merged = sketch_merge.ring_merge(st.sketch)
        else:
            merged = sketch_merge.allgather_merge(st.sketch, ell)
        return merged[None], sq[None], loss[None]

    merged, sq, loss = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P("data")),
        out_specs=(P("data", None, None), P("data"), P("data")),
        check_vma=False,
    )(tensors, valids, idf, starts)
    return merged[0], sq[0], loss[0]


def sharded_blocked_svd_reduce(cols, key: jax.Array, *, rank: int,
                               block: int, k_basis: int, mesh,
                               n_iter: int = 2, oversample: int = 8,
                               approx_knn: bool = False,
                               select: str = "strip", nbins: int = 0):
    """Distributed blocked randomized SVD of the implicit fused adjacency
    of a HUGE window — the multi-chip mirror of
    blocked_affinity.blocked_svd_reduce (reference TruncatedSVD,
    matrix_operations.py:143-147, at window sizes it cannot materialize).

    Row-sharded like sharded_blocked_fd_sketch: column features replicated,
    each chip rematerializes its contiguous range of (block, n) fused
    adjacency row blocks per sweep.  A·V products assemble row results with
    one psum of the (n, r) panel; Aᵀ·Q products psum per-chip partials; the
    tall-skinny QRs run replicated (O(n r²), negligible next to the
    sweeps).  Same randomized-SVD recipe and omega stream as the
    single-chip path — parity to rounding.  Returns (n, rank) = U·S
    replicated.  Requires block | n and p | (n // block).
    """
    _check_row_blocks(cols.n, block, mesh.shape["data"])
    return _sharded_blocked_svd_impl(
        cols.tensors, cols.valids, cols.idf, key, kinds=cols.kinds,
        rank=rank, block=block, k_basis=k_basis, mesh=mesh, n_iter=n_iter,
        oversample=oversample, approx_knn=approx_knn, select=select,
        nbins=nbins)


def sharded_spectral_embedding(cols, key: jax.Array, *, k_max: int,
                               block: int, k_basis: int, mesh,
                               n_iter: int = 6, oversample: int = 8,
                               approx_knn: bool = False,
                               select: str = "strip", nbins: int = 0):
    """Row-sharded normalized-cuts spectral embedding of the implicit fused
    adjacency — the multi-chip mirror of ops/blocked_spectral's sweeps
    (degrees, symmetrized M·V products) with the same subspace-iteration
    recipe.  Returns (ritz (n, k_max+oversample) basis, eigenvalues), both
    in descending eigenvalue order and replicated; the caller applies the
    NJW normalization + KMeans (blocked_spectral.labels_from_ritz) and may
    estimate the cluster count from the spectrum
    (blocked_spectral.eigengap_k_from_spectrum).
    """
    _check_row_blocks(cols.n, block, mesh.shape["data"])
    return _sharded_spectral_impl(
        cols.tensors, cols.valids, cols.idf, key, kinds=cols.kinds,
        k_max=k_max, block=block, k_basis=k_basis, mesh=mesh,
        n_iter=n_iter, oversample=oversample, approx_knn=approx_knn,
        select=select, nbins=nbins)


@functools.partial(jax.jit,
                   static_argnames=("kinds", "k_max", "block", "k_basis",
                                    "mesh", "n_iter", "oversample",
                                    "approx_knn", "select", "nbins"))
def _sharded_spectral_impl(tensors, valids, idf, key, *, kinds, k_max: int,
                           block: int, k_basis: int, mesh, n_iter: int,
                           oversample: int, approx_knn: bool, select: str,
                           nbins: int):
    from mused_tpu.ops import blocked_affinity as ba
    hi = jax.lax.Precision.HIGHEST
    t0 = tensors[0]
    n = (t0[0] if isinstance(t0, tuple) else t0).shape[0]
    m = min(k_max + oversample, n)
    starts = jnp.arange(n // block, dtype=jnp.int32) * block

    def body(tensors, valids, idf, starts_s):
        cols = ba.Columns(kinds=kinds, tensors=tensors, valids=valids,
                          idf=idf)

        def sweep(f, init):
            def step(acc, start):
                fused = ba.fused_rowblock(cols, start, block, k_basis,
                                          approx_knn, select, nbins)
                return f(acc, fused, start), None
            acc, _ = jax.lax.scan(step, init, starts_s)
            return acc

        def f_deg(carry, fused, start):
            row_sums, col_sums = carry
            row_sums = jax.lax.dynamic_update_slice_in_dim(
                row_sums, jnp.sum(fused, axis=1), start, axis=0)
            return row_sums, col_sums + jnp.sum(fused, axis=0)

        rs, cs_ = sweep(f_deg, (jnp.zeros(n), jnp.zeros(n)))
        deg = 0.5 * jax.lax.psum(rs + cs_, "data")
        inv_sqrt = jnp.where(deg > 0,
                             jax.lax.rsqrt(jnp.maximum(deg, 1e-12)), 0.0)

        def sym_matmul(v):     # ((A + A^T)/2) @ v, psum'd like the sweeps
            def f(carry, fused, start):
                av, atv = carry
                vb = jax.lax.dynamic_slice_in_dim(v, start, block, axis=0)
                av = jax.lax.dynamic_update_slice_in_dim(
                    av, jnp.dot(fused, v, precision=hi), start, axis=0)
                return av, atv + jnp.dot(fused.T, vb, precision=hi)
            av, atv = sweep(f, (jnp.zeros_like(v), jnp.zeros_like(v)))
            return 0.5 * jax.lax.psum(av + atv, "data")

        from mused_tpu.ops.blocked_spectral import ritz_from_products
        ritz, lam = ritz_from_products(sym_matmul, inv_sqrt, key, n=n, m=m,
                                       n_iter=n_iter)
        return ritz[None], lam[None]

    ritz, lam = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P("data")),
        out_specs=(P("data", None, None), P("data", None)),
        check_vma=False,
    )(tensors, valids, idf, starts)
    return ritz[0], lam[0]


@functools.partial(jax.jit,
                   static_argnames=("kinds", "rank", "block", "k_basis",
                                    "mesh", "n_iter", "oversample",
                                    "approx_knn", "select", "nbins"))
def _sharded_blocked_svd_impl(tensors, valids, idf, key, *, kinds,
                              rank: int, block: int, k_basis: int, mesh,
                              n_iter: int, oversample: int,
                              approx_knn: bool, select: str, nbins: int):
    from mused_tpu.ops import blocked_affinity as ba
    t0 = tensors[0]
    n = (t0[0] if isinstance(t0, tuple) else t0).shape[0]
    r = min(rank + oversample, n)
    starts = jnp.arange(n // block, dtype=jnp.int32) * block

    def body(tensors, valids, idf, starts_s):
        cols = ba.Columns(kinds=kinds, tensors=tensors, valids=valids,
                          idf=idf)

        def sweep(f):
            def step(acc, start):
                fused = ba.fused_rowblock(cols, start, block, k_basis,
                                          approx_knn, select, nbins,
                                          jnp.bfloat16)
                return f(acc, fused, start), None
            acc, _ = jax.lax.scan(step, jnp.zeros((n, r)), starts_s)
            return acc

        def mul_a(v):          # A @ v: rows assemble over the data axis
            def f(acc, fused, start):
                return jax.lax.dynamic_update_slice_in_dim(
                    acc, jnp.dot(fused.astype(jnp.float32), v,
                                 preferred_element_type=jnp.float32),
                    start, axis=0)
            return jax.lax.psum(sweep(f), "data")

        def mul_at(q):         # A^T @ q: per-chip partials psum
            def f(acc, fused, start):
                qb = jax.lax.dynamic_slice_in_dim(q, start, block, axis=0)
                return acc + jnp.dot(fused.astype(jnp.float32).T, qb,
                                     preferred_element_type=jnp.float32)
            return jax.lax.psum(sweep(f), "data")

        return ba.randomized_svd_from_products(
            mul_a, mul_at, key, n=n, rank=rank, oversample=oversample,
            n_iter=n_iter)[None]

    out = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P("data")),
        out_specs=P("data", None, None),
        check_vma=False,
    )(tensors, valids, idf, starts)
    return out[0]
