"""Batch engine: whole-subset pipeline (reference main.py:132-167).

adjacency over the full subset -> OR-fuse -> SVD reduce -> one clustering
pass (KMeans | DBSCAN | HDBSCAN).  The reference materializes a dense
subset^2 matrix (O(150k^2) at default scale, SURVEY.md §3.3 flags it); here
the adjacency+fusion device graph is the same jitted code as the streaming
engine, and a guard documents the dense-memory envelope (blocked/sharded
batch construction is the multi-chip path in parallel/).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from mused_tpu.ops import dbscan, kmeans, reduction, spectral
from mused_tpu.utils import metrics as metrics_mod
from mused_tpu.utils.config import PipelineConfig
from mused_tpu.engine.streaming import StreamingEngine

MAX_DENSE_ROWS = 32_768  # single-chip dense n^2 guard (~4GB f32 at the cap)
BLOCK_ROWS = 2_048       # row-block size for the rematerialized large path


def _pad_window_features(wf, pad: int):
    """Pad featurized rows with invalid entries (NaN coords, -1 ids)."""
    from mused_tpu.data import features as feat
    if isinstance(wf, feat.SparseWindowFeatures):
        return feat.SparseWindowFeatures(
            location=np.pad(wf.location, ((0, pad), (0, 0)),
                            constant_values=np.nan),
            times=np.pad(wf.times, ((0, pad), (0, 0))),
            user_ids=np.pad(wf.user_ids, (0, pad), constant_values=-1),
            tags_ids=np.pad(wf.tags_ids, ((0, pad), (0, 0)),
                            constant_values=-1),
            text_ids=np.pad(wf.text_ids, ((0, pad), (0, 0)),
                            constant_values=-1),
            text_cnt=np.pad(wf.text_cnt, ((0, pad), (0, 0))),
            tags_valid=np.pad(wf.tags_valid, (0, pad),
                              constant_values=False),
        )
    return feat.WindowFeatures(
        location=np.pad(wf.location, ((0, pad), (0, 0)),
                        constant_values=np.nan),
        times=np.pad(wf.times, ((0, pad), (0, 0))),
        user_ids=np.pad(wf.user_ids, (0, pad), constant_values=-1),
        tags=np.pad(wf.tags, ((0, pad), (0, 0))),
        text=np.pad(wf.text, ((0, pad), (0, 0))),
        tags_valid=np.pad(wf.tags_valid, (0, pad), constant_values=False),
    )


def _blocked_columns(data_modalities, modality_types, cfg):
    """Featurize the whole subset and pad rows to a block multiple (padding
    rows are invalid => zero adjacency rows).  Returns (Columns, block)."""
    from mused_tpu.data import features as feat
    from mused_tpu.ops import blocked_affinity as ba

    n = len(data_modalities[0])
    if list(modality_types) == ["location", "time", "username", "tags", "text"]:
        loc, tim, user, tags, text = data_modalities
        wf = feat.featurize_window(loc, tim, user, tags, text, cfg.features)
        block = min(BLOCK_ROWS, n)
        pad = (-n) % block
        if pad:
            wf = _pad_window_features(wf, pad)
        cols = ba.standard_columns(wf, cfg.features)
    else:
        mats = [np.asarray(m, np.float32) for m in data_modalities]
        block = min(BLOCK_ROWS, n)
        pad = (-n) % block
        if pad:
            mats = [np.pad(m, ((0, pad), (0, 0)), constant_values=np.nan)
                    for m in mats]
        cols = ba.generic_columns(mats, tuple(modality_types))
    return cols, block


def _blocked_reduce(data_modalities, modality_types, cfg, key):
    from mused_tpu.ops import blocked_affinity as ba
    from mused_tpu.ops import binned_select as bsel
    n = len(data_modalities[0])
    cols, block = _blocked_columns(data_modalities, modality_types, cfg)
    select, nbins = bsel.resolve_select(cfg, cols.n)
    reduced = ba.blocked_svd_reduce(cols, key, rank=cfg.reduced_dim,
                                    block=block, k_basis=cfg.k_basis,
                                    approx_knn=cfg.huge_window_approx_knn,
                                    select=select, nbins=nbins)
    return reduced[:n]


def process_batch_data(results, data_modalities, modality_types, reduced_dim,
                       k_basis, n_clusters, seed, approach,
                       complete_true_labels, noise_rate, label_mode, sorting,
                       eps, min_samples, min_cluster_size, window_size,
                       cfg: PipelineConfig | None = None):
    """Drop-in equivalent of reference main.py:132-167."""
    total_start = metrics_mod.now_ns()
    subset_size = len(data_modalities[0])
    if cfg is None:
        cfg = PipelineConfig(
            seed=seed, subset_size=subset_size, noise_rate=noise_rate,
            label_mode=label_mode, sorting=sorting, window_size=window_size,
            reduced_dim=reduced_dim, k_basis=k_basis, approach=approach,
            eps=eps, min_samples=min_samples, min_cluster_size=min_cluster_size)
    # cfg is the single source of truth past this point: the blocked path
    # reduced with cfg.* while the dense path used the raw arguments, so a
    # caller passing BOTH with mismatched values got silently different
    # embeddings across the MAX_DENSE_ROWS threshold (review r5)
    reduced_dim, k_basis = cfg.reduced_dim, cfg.k_basis
    eps, min_samples = cfg.eps, cfg.min_samples
    min_cluster_size = cfg.min_cluster_size

    key = jax.random.key(seed)
    if subset_size > MAX_DENSE_ROWS or cfg.force_blocked_batch:
        # large-subset path: the fused adjacency is never materialized —
        # blocked randomized SVD rematerializes (B, n) rows on the fly
        # (ops/blocked_affinity.py).  The reference's dense path would need
        # n^2 float64 (180GB at its own 150k default, SURVEY.md §3.3).
        if approach == "Spectral_batch":
            from mused_tpu.ops.blocked_spectral import spectral_clustering_blocked
            from mused_tpu.ops import binned_select as bsel
            cols, block = _blocked_columns(data_modalities, modality_types, cfg)
            select, nbins = bsel.resolve_select(cfg, cols.n)
            labels = spectral_clustering_blocked(
                cols, int(n_clusters), key, k_max=max(int(n_clusters), 2),
                block=block, k_basis=k_basis, n_real=subset_size,
                approx_knn=cfg.huge_window_approx_knn,
                select=select, nbins=nbins)
            total_end = metrics_mod.now_ns()
            return metrics_mod.compute_all_metrics(
                results, subset_size, noise_rate, label_mode, sorting,
                reduced_dim, k_basis, window_size, np.asarray(labels),
                np.asarray(complete_true_labels), total_end, total_start)
        reduced = _blocked_reduce(data_modalities, modality_types, cfg, key)
        fused = None
        if approach in ("DBSCAN_batch", "HDBSCAN_batch"):
            # blocked density clustering: n^2 never materialized
            if approach == "DBSCAN_batch":
                from mused_tpu.ops.blocked_dbscan import dbscan_blocked
                all_clusters = dbscan_blocked(np.asarray(reduced), eps=eps,
                                              min_samples=min_samples)
            else:
                # dbscan.hdbscan routes by platform/size: device Boruvka on
                # an accelerator (its n^2 sweeps are matmuls), host
                # on-the-fly Prim on CPU — one O(n^2 d) pass vs Boruvka's
                # O(log n) sweeps (~10x at the reference's own 150k default
                # on a CPU host)
                all_clusters = dbscan.hdbscan(
                    np.asarray(reduced), min_cluster_size=min_cluster_size,
                    min_samples=min_samples)
            total_end = metrics_mod.now_ns()
            return metrics_mod.compute_all_metrics(
                results, subset_size, noise_rate, label_mode, sorting,
                reduced_dim, k_basis, window_size, all_clusters,
                np.asarray(complete_true_labels), total_end, total_start)
    else:
        # reuse the streaming engine's featurize+fuse graph on the whole subset
        helper = StreamingEngine(cfg.replace(window_size=max(subset_size, 2)))
        fused = helper.fused_adjacency(data_modalities, modality_types)
        reduced = reduction.svd_reduce(fused, reduced_dim, key)

    if approach == "Spectral_batch":
        labels = spectral.spectral_clustering(fused, jnp.int32(n_clusters), key,
                                              k_max=max(int(n_clusters), 2))
        all_clusters = np.asarray(labels)
    elif approach == "HDBSCAN_batch":
        all_clusters = dbscan.hdbscan(np.asarray(reduced),
                                      min_cluster_size=min_cluster_size,
                                      min_samples=min_samples)
    elif approach == "DBSCAN_batch":
        all_clusters = dbscan.dbscan(np.asarray(reduced), eps=eps,
                                     min_samples=min_samples)
    else:
        labels, _ = kmeans.kmeans(reduced, jnp.int32(n_clusters), key,
                                  k_max=max(int(n_clusters), 2))
        all_clusters = np.asarray(labels)

    total_end = metrics_mod.now_ns()
    all_true = np.asarray(complete_true_labels)
    return metrics_mod.compute_all_metrics(
        results, subset_size, noise_rate, label_mode, sorting, reduced_dim,
        k_basis, window_size, np.asarray(all_clusters), all_true,
        total_end, total_start)
