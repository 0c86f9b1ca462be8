"""Streaming engine: the tumbling/sliding-window pipeline.

Reproduces reference main.py:13-130 (process_streaming_data) as a host loop
around ONE jitted device graph per window:

    featurize (host) ->
      [adjacency x5 -> OR-fuse -> (SWFD update+query | randomized SVD)
       -> (KMeans | MiniBatchKMeans)]  (single jit, state donated) ->
    cluster matching (host, tiny) -> metric accumulation (host)

vs the reference's per-window sequence of sklearn calls and a per-row Python
``swfd.fit`` loop.  DBSCAN-family approaches split the graph: the device step
returns the reduced matrix and the density clustering runs via the device
DBSCAN propagation kernel under host glue (ops/dbscan.py).

Window semantics preserved exactly (SURVEY.md §2.4): trigger at
``len(window)==window_size and (i+1)*step_window_ratio % window_size == 0``;
per-window n_clusters = unique ground-truth labels in the window (quirk);
SWFD sketch state persists across the whole stream; SWFDMC's reduced matrix
is the transposed sketch; clustering-failure fallback assigns all-noise.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from mused_tpu.data import features as feat
from mused_tpu.ops import affinity, dbscan, fd, kmeans, matching, reduction, spectral, swfd
from mused_tpu.utils import metrics as metrics_mod, profiling
from mused_tpu.utils.config import PipelineConfig
from mused_tpu.utils.runtime import platform_paths


class StreamState(NamedTuple):
    """Cross-window device state."""

    swfd: swfd.SWFDState
    minibatch: kmeans.MiniBatchState


class _PendingWindow(NamedTuple):
    """A dispatched-but-not-pulled window (dispatch_window/finalize_window).

    ``state`` is the post-window device state — kept here because by
    finalize time ``engine.state`` may already hold the NEXT window's
    (pipelined) state, and checkpoints must save the state matching the
    last FINALIZED window.  ``clusters`` short-circuits paths that complete
    synchronously (huge windows)."""

    window_index: int
    reduced: object = None
    labels: object = None
    r_norm: object = None
    stable_feats: object = None
    verbose: bool = False
    state: object = None
    clusters: object = None


def _fuse_standard(location, times, user_ids, tags, text, k_basis: int,
                   tags_valid=None):
    return affinity.multimodal_fused_adjacency(
        location, times, user_ids, tags, text, k_basis=k_basis,
        tags_valid=tags_valid)


@functools.partial(jax.jit,
                   static_argnames=("k_basis", "tags_dim", "text_dim"))
def _fuse_standard_sparse(location, times, user_ids, tags_ids, text_ids,
                          text_cnt, tags_valid, *, k_basis: int,
                          tags_dim: int, text_dim: int):
    """Sparse-token variant: scatter tokens to dense on device, then the same
    five modality graphs + fusion."""
    tags = affinity.counts_from_tokens(tags_ids, None, tags_dim)
    text = affinity.counts_from_tokens(text_ids, text_cnt, text_dim)
    return affinity.multimodal_fused_adjacency(
        location, times, user_ids, tags, text, k_basis=k_basis,
        tags_valid=tags_valid)


@functools.partial(jax.jit, static_argnames=("k_basis", "types"))
def _fuse_generic(mats: tuple, *, k_basis: int, types: tuple):
    """Numeric-modality path (synthetic streams, dense embeddings): per-type
    kNN adjacency + OR fusion.  "embedding" = cosine kNN (BASELINE.md #2/#4);
    anything else = Euclidean kNN (ref matrix_operations.py:112-119)."""
    mk = {"embedding": affinity.embedding_adjacency,
          "location": affinity.location_adjacency,
          "time": affinity.time_adjacency}
    return affinity.fuse([
        mk.get(t, affinity.euclidean_adjacency)(m, k_basis)
        for m, t in zip(mats, types)])


def _window_step_impl(state: StreamState, fused: jax.Array,
                      n_clusters: jax.Array, key: jax.Array, *, approach: str,
                      k_basis: int, reduced_dim: int, k_max: int, window: int,
                      fd_shrink: str = "subspace",
                      k_source: str = "given", need_reduced: bool = True,
                      eigengap_theta: float = 0.15,
                      background: bool = False):
    """Device portion of one window given the fused adjacency matrix.

    Returns (new_state, reduced (n, reduced_dim or sketch row space), labels
    (n,) or zeros for host-clustered approaches).  Plain traceable function —
    jitted per-window as ``_window_step`` and inlined into the scanned
    multi-window dispatch (``_scanned_window_steps``).

    ``k_source="eigengap"`` ignores the passed ``n_clusters`` and estimates
    the per-window cluster count on device from the reduced window's
    singular-value profile (ops/reduction.eigengap_k) — the unsupervised
    replacement for the reference's ground-truth-derived count (main.py:41).
    """
    n = fused.shape[0]

    if approach == "SWFDMC":
        # one whole-window FD fold (one summary block, few sequential
        # eighs) sealed into the sliding-window ring —
        # replaces the reference's n sequential swfd.fit(row) calls
        # (main.py:65-67) with one scanned fold (see fd.fold_sketch).
        # Semantics note: the reference feeds ALL n fused-matrix rows at EVERY
        # trigger (even overlapping sliding triggers), and with N=window_size
        # the sketch then covers exactly this trigger's rows — absorbing one
        # whole-window summary block per trigger reproduces that in both
        # tumbling and sliding modes.  (Row-granular streaming remains
        # available via ops.swfd.update / SeqBasedSWFD.)
        ell = state.swfd.ell
        # the whole-window summary is a FOLD (one-shot sketch of n rows):
        # "subspace" resolves to the Gram-free Rayleigh-Ritz shrink there,
        # which measured lower spectral error than the Newton-Schulz chain
        # at window=2048/d=1024 (257 vs 291)
        blk, sq_fro, loss = fd.fold_sketch(
            fused, ell=ell, mode=fd.resolve_fold_mode(fd_shrink))
        new_swfd = swfd.absorb_summary(state.swfd, blk, jnp.int32(n), sq_fro,
                                       loss)
        sketch, _, _, _ = swfd.query(new_swfd, window=window,
                                     sketch_dim=reduced_dim)
        # sketch is (reduced_dim, d=n): transpose so rows index datapoints
        # (the reference's transpose workaround, main.py:73-76)
        reduced = sketch.T
        state = state._replace(swfd=new_swfd)
    elif approach == "sSpectral" and not need_reduced:
        # sSpectral's labels come entirely from spectral_clustering(fused)
        # below; its SVD reduction is consumed only by the verbose debug
        # oracle (the engine sets need_reduced=True then).  As a jit OUTPUT
        # the reduction can't be DCE'd, so skip the (2+2*n_iter) randomized-
        # SVD sweeps it would cost every window.
        reduced = jnp.zeros((n, 0), jnp.float32)
    else:
        reduced = reduction.svd_reduce(fused, reduced_dim, key)

    if k_source == "eigengap" and approach != "sSpectral":
        n_clusters = reduction.eigengap_k(reduced, k_max=k_max,
                                          theta=eigengap_theta)

    if approach == "sSpectral":
        # spectral clustering works on the affinity graph itself; under
        # "eigengap" its count comes from the normalized-affinity spectrum
        # the embedding eigh already computes (not the reduced energies of
        # the raw adjacency — a different operator)
        labels = spectral.spectral_clustering(fused, n_clusters, key,
                                              k_max=k_max, k_source=k_source,
                                              background=background)
    elif approach == "sSVDMC_mini":
        new_mbk, labels = kmeans.minibatch_step(state.minibatch, reduced, key)
        state = state._replace(minibatch=new_mbk)
        # background bucket unsupported here: the MiniBatch centroids are
        # cross-window running means, so window residuals mix scales
    elif approach in ("DBSCAN_incr", "DBSCAN_centr"):
        labels = jnp.zeros((n,), jnp.int32)   # clustered by host glue
    else:
        labels, _ = kmeans.kmeans(reduced, n_clusters, key, k_max=k_max)
        if background:
            labels = kmeans.mark_background(reduced, labels, k_max=k_max)
    return state, reduced, labels


_window_step = functools.partial(jax.jit, static_argnames=(
    "approach", "k_basis", "reduced_dim", "k_max", "window",
    "fd_shrink", "k_source", "need_reduced", "eigengap_theta", "background"),
    donate_argnames=("state",))(_window_step_impl)


LARGE_WINDOW_ROWS = 32_768   # beyond this, windows use rematerialized blocks
LARGE_BLOCK = 2_048


def _auto_col_shards(p: int) -> int:
    """Balanced grid factor: the largest divisor of p <= sqrt(p) (memory
    users who know their panel sizes set huge_window_col_shards directly)."""
    best = 1
    d = 1
    while d * d <= p:
        if p % d == 0:
            best = d
        d += 1
    return best


def effective_verbose(cfg: PipelineConfig) -> bool:
    """True only when the small-window debug oracles actually print
    (reference main.py:35-37: subset < 1000 eyeball prints).  The scanned
    and dispatch-ahead gates key off THIS, not raw cfg.verbose — a
    --verbose run at window_size > 1000 prints nothing, and silently
    paying per-window dispatch for it cost the ~3x scanned speedup
    (review r5 finding)."""
    return cfg.verbose and cfg.window_size <= 1000

def resolve_windows_per_batch(cfg: PipelineConfig, *, standard_types: bool,
                              step_window_ratio: int | None = None,
                              checkpoint_dir: str | None = None,
                              backend: str | None = None,
                              n_windows: int | None = None) -> int:
    """Resolve ``cfg.windows_per_batch`` (None = auto) to a concrete W.

    Auto: the platform's W (utils.runtime.platform_paths; ``backend``
    names the platform, default JAX's) for eligible configs — scanned
    dispatch is tested numerically identical to per-window dispatch, so
    the choice is speed alone; ``windows_per_batch=1`` opts out (serving's
    label lag is W-1+max_lag windows).  The tail group is PADDED to the
    static W by repeating the last window (_run_batched group_at; extra
    outputs dropped), so when the caller knows the stream's length
    (``n_windows`` — the offline loop does, serving does not) auto halves
    W while a quarter or more of the padded window steps would be padding
    (on the H100, W=8 won at 75 windows, 5 of 80 steps padded, and lost to
    W=4 at 12 windows, 4 of 16 padded; PERF.md).  Checkpointing and
    verbose stay per-window under auto: batched saves land only at group
    boundaries, and the scanned body has no per-window debug oracles
    (explicit W>1 still composes with checkpoint_dir).

    EXPLICIT W>1 is clamped back to 1 when the config can't run scanned at
    all (non-batchable approach — the scanned body has no host clustering
    glue and would return placeholder labels; sliding ratio; huge windows;
    centroid matching on standard streams): the one eligibility rule for
    the offline loop AND serving, so neither can dispatch a non-batchable
    approach scanned (review r3 finding #1).
    """
    ratio = (cfg.step_window_ratio if step_window_ratio is None
             else step_window_ratio)
    hard_eligible = (cfg.approach in BATCHABLE_APPROACHES
                     and ratio == 1
                     and not cfg.force_blocked_window
                     and cfg.window_size <= LARGE_WINDOW_ROWS
                     and not (cfg.matching == "centroid" and standard_types))
    batch_w = getattr(cfg, "windows_per_batch", None)
    if batch_w is None:
        auto_w = platform_paths(backend).windows_per_batch
        while auto_w > 1 and n_windows is not None:
            steps = -(-n_windows // auto_w) * auto_w   # tail padded to W
            if 4 * (steps - n_windows) < steps:
                break
            auto_w //= 2
        batch_w = auto_w if (hard_eligible and not checkpoint_dir
                             and not effective_verbose(cfg)) else 1
    batch_w = max(int(batch_w), 1)
    return batch_w if hard_eligible else 1


# approaches whose per-window host glue is only the label matching (no
# per-window host clustering like the DBSCAN family) — eligible for scanned
# multi-window dispatch; device state (SWFD ring, MiniBatch centroids)
# threads through the scan carry exactly as in per-window dispatch
BATCHABLE_APPROACHES = ("SWFDMC", "sSVDMC", "sSVDMC_hung", "sSVDMC_pot",
                        "sSVDMC_mini", "sSpectral")


def scanned_group_dispatch(engine: "StreamingEngine", feats_batch: tuple,
                           n_clusters, keys, *, types: tuple,
                           k_source: str):
    """One scanned multi-window device dispatch through the engine's
    configured path (SPMD when a mesh is set, else single-chip) — the ONE
    place the ~15-kwarg scanned call is spelled, shared by the offline
    batched loop and serving's group dispatch so their plumbing can never
    drift (round-5 review: a static added to only 3 of the 4 spelled-out
    copies silently diverged serving semantics).  Advances
    ``engine.state``; returns (batch_labels (W, n), r_norms (W,))."""
    cfg = engine.cfg
    if engine.mesh is not None:
        from mused_tpu.parallel import sharded as shard_mod
        new_swfd, new_mb, batch_labels, r_norms = \
            shard_mod.sharded_scanned_steps(
                engine.state.swfd, engine.state.minibatch, feats_batch,
                n_clusters, keys, approach=cfg.approach,
                k_basis=cfg.k_basis, reduced_dim=cfg.reduced_dim,
                k_max=engine.k_max, window=cfg.window_size,
                fd_shrink=cfg.fd_shrink, types=types,
                tags_dim=cfg.features.tags_hash_dim,
                text_dim=cfg.features.text_hash_dim, mesh=engine.mesh,
                topology=cfg.merge_topology, k_source=k_source,
                eigengap_theta=cfg.eigengap_theta,
                background=cfg.background_bucket)
        engine.state = StreamState(swfd=new_swfd, minibatch=new_mb)
    else:
        engine.state, batch_labels, r_norms = _scanned_window_steps(
            engine.state, feats_batch, n_clusters, keys,
            approach=cfg.approach, k_basis=cfg.k_basis,
            reduced_dim=cfg.reduced_dim, k_max=engine.k_max,
            window=cfg.window_size,
            fd_shrink=cfg.fd_shrink, types=types,
            tags_dim=cfg.features.tags_hash_dim,
            text_dim=cfg.features.text_hash_dim, k_source=k_source,
            eigengap_theta=cfg.eigengap_theta,
            background=cfg.background_bucket)
    return batch_labels, r_norms


@functools.partial(
    jax.jit,
    static_argnames=("approach", "k_basis", "reduced_dim", "k_max", "window",
                     "fd_shrink", "types",
                     "tags_dim", "text_dim", "k_source", "eigengap_theta",
                     "background"),
    donate_argnames=("state",))
def _scanned_window_steps(state: StreamState, feats_batch: tuple,
                          n_clusters: jax.Array, keys: jax.Array, *,
                          approach: str, k_basis: int, reduced_dim: int,
                          k_max: int, window: int,
                          fd_shrink: str, types: tuple,
                          tags_dim: int, text_dim: int,
                          k_source: str = "given",
                          eigengap_theta: float = 0.15,
                          background: bool = False):
    """W tumbling windows in ONE dispatch: ``lax.scan`` over the window axis.

    Amortizes the per-window dispatch cost while staying numerically
    identical to per-window dispatch: unlike a vmap batch, the scan
    (a) threads the real cross-window device state (SWFD ring, MiniBatch
    centroids) through the carry, and (b) keeps ``lax.cond`` a real branch
    so the subspace shrink's gated eigh fallback stays off the hot path.
    Host-side label matching chains the returned per-window labels
    afterwards.
    """

    def body(state, per_window):
        feats, k, key = per_window
        fused = _fuse_dispatch(feats, types=types, k_basis=k_basis,
                               tags_dim=tags_dim, text_dim=text_dim)
        r_norm = jnp.max(jnp.sum(fused * fused, axis=1))
        state, _, labels = _window_step_impl(
            state, fused, k, key, approach=approach, k_basis=k_basis,
            reduced_dim=reduced_dim, k_max=k_max, window=window,
            fd_shrink=fd_shrink, k_source=k_source,
            eigengap_theta=eigengap_theta, background=background)
        return state, (labels, r_norm)

    state, (labels, r_norms) = jax.lax.scan(
        body, state, (feats_batch, n_clusters, keys))
    return state, labels, r_norms


def _types_for(features, modality_types) -> tuple:
    """Feature-layout tag for the fuse dispatch (see _fuse_dispatch)."""
    if isinstance(features, feat.SparseWindowFeatures):
        return ("standard_sparse",)
    if isinstance(features, feat.WindowFeatures):
        return ("standard",)
    return tuple(modality_types)


def _fuse_dispatch(feats: tuple, *, types: tuple, k_basis: int,
                   tags_dim: int, text_dim: int) -> jax.Array:
    """Traceable fused-adjacency dispatch over the three feature layouts —
    shared by the scanned multi-window body and the combined single-window
    step.  ``types``: ("standard_sparse",) | ("standard",) | generic
    modality-type tuple."""
    if types[0] == "standard_sparse":
        loc, tim, uid, tags_ids, text_ids, text_cnt, tags_valid = feats
        return _fuse_standard_sparse(
            loc, tim, uid.astype(jnp.int32), tags_ids, text_ids,
            text_cnt, tags_valid, k_basis=k_basis, tags_dim=tags_dim,
            text_dim=text_dim)
    if types == ("standard",):
        loc, tim, uid, tags, text, tags_valid = feats
        return _fuse_standard(loc, tim, uid.astype(jnp.int32),
                              tags.astype(jnp.float32),
                              text.astype(jnp.float32), k_basis, tags_valid)
    return _fuse_generic(feats, k_basis=k_basis, types=types)


@functools.partial(
    jax.jit,
    static_argnames=("approach", "k_basis", "reduced_dim", "k_max", "window",
                     "fd_shrink", "types",
                     "tags_dim", "text_dim", "k_source", "need_reduced",
                     "eigengap_theta", "background"),
    donate_argnames=("state",))
def _combined_window_step(state: StreamState, feats: tuple,
                          n_clusters: jax.Array, key: jax.Array, *,
                          approach: str, k_basis: int, reduced_dim: int,
                          k_max: int, window: int,
                          fd_shrink: str, types: tuple,
                          tags_dim: int, text_dim: int,
                          k_source: str = "given",
                          need_reduced: bool = True,
                          eigengap_theta: float = 0.15,
                          background: bool = False):
    """Fusion + window step in ONE dispatch (the per-window default path):
    folding the adjacency build into the window step halves the per-window
    dispatch count, and the fused matrix never leaves the device.  Also
    returns the fused matrix's max squared row norm (the reference's sketch
    bound R, main.py:61)."""
    fused = _fuse_dispatch(feats, types=types, k_basis=k_basis,
                           tags_dim=tags_dim, text_dim=text_dim)
    r_norm = jnp.max(jnp.sum(fused * fused, axis=1))
    state, reduced, labels = _window_step_impl(
        state, fused, n_clusters, key, approach=approach, k_basis=k_basis,
        reduced_dim=reduced_dim, k_max=k_max, window=window,
        fd_shrink=fd_shrink, k_source=k_source,
        need_reduced=need_reduced, eigengap_theta=eigengap_theta,
        background=background)
    return state, reduced, labels, r_norm


class StreamingEngine:
    """Host orchestration of the streaming pipeline for one approach."""

    def __init__(self, cfg: PipelineConfig, d_per_modality: Sequence[int] | None = None):
        self.cfg = cfg
        n = cfg.window_size
        ell = min(cfg.reduced_dim, n)
        self.k_max = max(cfg.n_clusters_total, 2)
        # SWFD state is O(slots * ell * n); only pay for it when used.
        # Summary blocks are whole windows -> block_rows = n (2 ring
        # slots).  The HUGE-window path computes its sketch via the
        # blocked sweeps (never reads state.swfd), so it gets the dummy
        # too — at capacity scale the unused ring would be ~3*ell*n
        # floats of zeros in HBM and in every checkpoint.
        huge = n > LARGE_WINDOW_ROWS or cfg.force_blocked_window
        swfd_state = (swfd.init(n, n, ell, block_rows=n)
                      if cfg.approach == "SWFDMC" and not huge
                      else swfd.init(1, 1, 1, block_rows=1))
        self.state = StreamState(
            swfd=swfd_state,
            minibatch=kmeans.minibatch_init(self.k_max, cfg.reduced_dim),
        )
        self.incr_clusterer: dbscan.IncrementalDBSCAN | None = None
        self.prev_centroids = None
        self.prev_centroid_labels = None
        # centroid matching (cfg.matching="centroid"): stable-ID registry in
        # input feature space (ops/matching.CentroidMatcher)
        self.centroid_matcher = (
            matching.CentroidMatcher(cfg.centroid_max_dist)
            if cfg.matching == "centroid" else None)
        if huge and cfg.approach == "DBSCAN_incr":
            raise ValueError(
                "DBSCAN_incr accumulates every inserted point (exact "
                "incremental semantics) and runs dense-window-only; huge "
                f"windows need window_size <= {LARGE_WINDOW_ROWS} or "
                "DBSCAN_centr")
        if cfg.matching == "centroid" and (
                cfg.window_size > LARGE_WINDOW_ROWS or cfg.force_blocked_window):
            raise ValueError(
                "matching='centroid' runs on the dense-window path (it needs "
                "the window's numeric feature matrix); huge windows use the "
                "reference positional matching or DBSCAN_centr")
        if cfg.k_estimate not in ("labels", "fixed", "eigengap"):
            raise ValueError(
                f"k_estimate={cfg.k_estimate!r}: expected 'labels' "
                "(reference ground-truth count), 'fixed' (n_clusters_total) "
                "or 'eigengap' (unsupervised device estimate)")
        self.swfd_R: float | None = None   # recorded like reference main.py:61
        self.timer = profiling.SpanTimer()  # per-phase spans (SURVEY.md §5.1)
        # multi-chip: every window step runs SPMD over this mesh's "data" axis
        # (parallel/sharded.sharded_engine_step); None = single-chip
        self.mesh = None
        # static layout-config coherence first, resource checks after
        if cfg.huge_window_layout not in ("rows", "columns", "grid"):
            raise ValueError(
                f"huge_window_layout={cfg.huge_window_layout!r}: expected "
                "'rows' (replicated features, row blocks sharded), "
                "'columns' (features column-sharded — the capacity layout) "
                "or 'grid' (row groups x column shards)")
        if (cfg.huge_window_layout in ("columns", "grid")
                and cfg.huge_window_fused_select is False):
            raise ValueError(
                "huge_window_layout='columns'/'grid' IS the fused "
                "stride-binned selection sharded over the mesh (a full sim "
                "strip cannot exist on one chip there); "
                "huge_window_fused_select=False is contradictory")
        if cfg.data_shards > 1:
            from mused_tpu.parallel import mesh as mesh_mod
            if cfg.window_size % cfg.data_shards:
                raise ValueError(
                    f"window_size={cfg.window_size} must be divisible by "
                    f"data_shards={cfg.data_shards} (rows shard evenly)")
            if len(jax.devices()) < cfg.data_shards:
                raise ValueError(
                    f"data_shards={cfg.data_shards} but only "
                    f"{len(jax.devices())} devices visible")
            if (cfg.huge_window_layout in ("columns", "grid")
                    and not (cfg.window_size > LARGE_WINDOW_ROWS
                             or cfg.force_blocked_window)):
                raise ValueError(
                    f"huge_window_layout={cfg.huge_window_layout!r} shards "
                    "the rematerialized huge-window sweep; dense windows "
                    "(<= 32k rows, no force_blocked_window) replicate "
                    "nothing worth sharding — use 'rows'")
            if cfg.huge_window_layout == "grid":
                if cfg.huge_window_col_shards:
                    cs_ = cfg.huge_window_col_shards
                    if cs_ < 2 or cfg.data_shards % cs_:
                        raise ValueError(
                            f"huge_window_col_shards={cs_} must be >= 2 and "
                            f"divide data_shards={cfg.data_shards} (use "
                            "layout='columns' for all-column sharding)")
                else:
                    cs_ = _auto_col_shards(cfg.data_shards)
                    if cs_ < 2:
                        raise ValueError(
                            f"data_shards={cfg.data_shards} has no balanced "
                            "grid factorization (it is prime or 2); pass "
                            "huge_window_col_shards explicitly or use "
                            "layout='columns'")
                self.mesh = mesh_mod.make_mesh(
                    n_data=cfg.data_shards // cs_, n_model=cs_)
            else:
                self.mesh = mesh_mod.make_mesh(n_data=cfg.data_shards)
        elif cfg.huge_window_layout in ("columns", "grid"):
            raise ValueError(
                f"huge_window_layout={cfg.huge_window_layout!r} needs "
                "data_shards > 1 (there is nothing to shard the features "
                "over on one chip)")

    # ------------------------------------------------------------------
    def host_snapshot(self) -> dict:
        """Picklable host-side cross-window state (for checkpointing)."""
        inc = self.incr_clusterer
        cm = self.centroid_matcher
        return {
            "swfd_R": self.swfd_R,
            "prev_centroids": self.prev_centroids,
            "prev_centroid_labels": self.prev_centroid_labels,
            "incr_state": None if inc is None else inc.snapshot(),
            "centroid_matcher": None if cm is None else cm.snapshot(),
        }

    def restore(self, device_state: StreamState, host: dict) -> None:
        """Inverse of (state, host_snapshot()) — resume from a checkpoint."""
        self.state = device_state
        self.swfd_R = host.get("swfd_R")
        self.prev_centroids = host.get("prev_centroids")
        self.prev_centroid_labels = host.get("prev_centroid_labels")
        if host.get("incr_state") is not None:
            self.incr_clusterer = dbscan.IncrementalDBSCAN.from_snapshot(
                host["incr_state"])
        elif host.get("incr_buf") is not None:   # pre-exact-mode checkpoints
            # those checkpoints were written under the old bounded default:
            # preserve its semantics so resume == the uninterrupted legacy run
            self.incr_clusterer = dbscan.IncrementalDBSCAN(
                eps=self.cfg.eps, min_pts=self.cfg.min_samples,
                max_buffer=8192)
            self.incr_clusterer.insert(host["incr_buf"])
        if host.get("centroid_matcher") is not None:
            self.centroid_matcher = matching.CentroidMatcher.from_snapshot(
                host["centroid_matcher"])

    # ------------------------------------------------------------------
    def _process_window_large(self, features, modality_types,
                              window_true_labels, window_index: int,
                              prev_clusters) -> np.ndarray:
        """Huge-window path (BASELINE.md #3: e.g. 100k-row windows): the
        window's fused adjacency is never materialized — FD sketch / blocked
        randomized SVD consume rematerialized (B, n) row blocks."""
        from mused_tpu.ops import blocked_affinity as ba
        from mused_tpu.data import features as featmod
        cfg = self.cfg
        n = cfg.window_size
        # sharded sweep: each of the p chips needs an equal share of row
        # blocks, so size blocks from the per-chip range and pad to block*p
        # (p = TOTAL mesh devices: padding to block*p satisfies every
        # layout's divisibility — per-chip row ranges for "rows", column
        # shards for "columns", and both factors of the "grid")
        p = 1
        if self.mesh is not None:
            p = self.mesh.shape["data"] * self.mesh.shape.get("model", 1)
        block = min(LARGE_BLOCK, max(n // p, 1))
        pad = (-n) % (block * p)
        # "columns"/"grid" layouts: the features themselves shard over the
        # mesh — never build the full-window column panels on any one device
        col_layout = (self.mesh is not None
                      and cfg.huge_window_layout in ("columns", "grid"))
        feats_t = types_t = None
        if isinstance(features, (featmod.WindowFeatures,
                                 featmod.SparseWindowFeatures)):
            if pad:
                from mused_tpu.engine.batch import _pad_window_features
                features = _pad_window_features(features, pad)
            if col_layout:
                feats_t = tuple(features)
                types_t = _types_for(features, modality_types)
            else:
                cols = ba.standard_columns(features, cfg.features)
        else:
            mats = [np.pad(np.asarray(m, np.float32), ((0, pad), (0, 0)),
                           constant_values=np.nan) if pad else m
                    for m in features]
            if col_layout:
                feats_t = tuple(np.asarray(m, np.float32) for m in mats)
                types_t = tuple(modality_types)
            else:
                cols = ba.generic_columns(mats, tuple(modality_types))

        if cfg.approach == "DBSCAN_incr":
            raise ValueError(
                "DBSCAN_incr accumulates every inserted point (exact "
                "incremental semantics); at huge windows use DBSCAN_centr "
                "(blocked) instead")
        # stride-binned candidate selection: the platform's default, or per
        # the explicit config override
        from mused_tpu.ops import binned_select as bsel
        if not col_layout:
            select, nbins = bsel.resolve_select(cfg, cols.n)
        key = jax.random.fold_in(jax.random.key(cfg.seed), window_index)
        with self.timer.span("device_step"):
            if cfg.approach == "SWFDMC":
                ell = min(cfg.reduced_dim, n)
                if col_layout:
                    # capacity layout: feature shards + column-sharded FD
                    # fold (parallel/colsharded) — each chip holds 1/p of
                    # the window's panels
                    from mused_tpu.parallel import colsharded as cs
                    sk, sq_fro, _loss = cs.colsharded_blocked_fd_sketch(
                        feats_t, types_t, ell=ell, block=block,
                        k_basis=cfg.k_basis, mesh=self.mesh,
                        mode=cfg.fd_shrink,
                        tags_dim=cfg.features.tags_hash_dim,
                        text_dim=cfg.features.text_hash_dim,
                        cand_fold=cfg.huge_window_cand_fold)
                elif self.mesh is not None:
                    # row-sharded blocked sweep + sketch merge: each chip
                    # rematerializes its own range of adjacency row blocks
                    from mused_tpu.parallel import sharded as shard_mod
                    n_pad = cols.n
                    p = self.mesh.shape["data"]
                    if (n_pad // block) % p:
                        raise ValueError(
                            f"huge-window SPMD needs the {n_pad // block} row "
                            f"blocks (block={block}) to split evenly over "
                            f"data_shards={p}")
                    sk, sq_fro, _loss = shard_mod.sharded_blocked_fd_sketch(
                        cols, ell=ell, block=block, k_basis=cfg.k_basis,
                        mesh=self.mesh, topology=cfg.merge_topology,
                        mode=cfg.fd_shrink,
                        approx_knn=cfg.huge_window_approx_knn,
                        select=select, nbins=nbins,
                        cand_fold=cfg.huge_window_cand_fold)
                else:
                    sk, sq_fro, _loss = ba.blocked_fd_sketch(
                        cols, ell=ell, block=block, k_basis=cfg.k_basis,
                        mode=cfg.fd_shrink,
                        approx_knn=cfg.huge_window_approx_knn,
                        select=select, nbins=nbins,
                        cand_fold=cfg.huge_window_cand_fold)
                # the padded columns are invalid -> their adjacency columns
                # are zero; slice the sketch back to d=n
                reduced = sk.T[:n]
            elif cfg.approach == "sSpectral":
                reduced = None   # blocked spectral consumes cols directly —
                                 # don't pay (2+2*n_iter) SVD sweeps it ignores
            elif col_layout:
                from mused_tpu.parallel import colsharded as cs
                reduced = cs.colsharded_blocked_svd_reduce(
                    feats_t, types_t, key, rank=cfg.reduced_dim,
                    block=block, k_basis=cfg.k_basis, mesh=self.mesh,
                    tags_dim=cfg.features.tags_hash_dim,
                    text_dim=cfg.features.text_hash_dim)[:n]
            elif self.mesh is not None:
                from mused_tpu.parallel import sharded as shard_mod
                reduced = shard_mod.sharded_blocked_svd_reduce(
                    cols, key, rank=cfg.reduced_dim, block=block,
                    k_basis=cfg.k_basis, mesh=self.mesh,
                    approx_knn=cfg.huge_window_approx_knn,
                    select=select, nbins=nbins)[:n]
            else:
                reduced = ba.blocked_svd_reduce(
                    cols, key, rank=cfg.reduced_dim, block=block,
                    k_basis=cfg.k_basis,
                    approx_knn=cfg.huge_window_approx_knn,
                    select=select, nbins=nbins)[:n]
            if cfg.approach == "sSVDMC_mini":
                new_mbk, labels = kmeans.minibatch_step(
                    self.state.minibatch, reduced, key)
                self.state = self.state._replace(minibatch=new_mbk)
                clusters = np.asarray(labels)
            elif cfg.approach == "sSpectral":
                from mused_tpu.ops import blocked_spectral as bspec
                if col_layout:
                    from mused_tpu.parallel import colsharded as cs
                    ritz, lam = cs.colsharded_spectral_embedding(
                        feats_t, types_t, key, k_max=self.k_max,
                        block=block, k_basis=cfg.k_basis, mesh=self.mesh,
                        tags_dim=cfg.features.tags_hash_dim,
                        text_dim=cfg.features.text_hash_dim)
                elif self.mesh is not None:
                    from mused_tpu.parallel import sharded as shard_mod
                    ritz, lam = shard_mod.sharded_spectral_embedding(
                        cols, key, k_max=self.k_max, block=block,
                        k_basis=cfg.k_basis, mesh=self.mesh,
                        approx_knn=cfg.huge_window_approx_knn,
                        select=select, nbins=nbins)
                else:
                    ritz, lam = bspec.spectral_embedding_blocked(
                        cols, key, k_max=self.k_max, block=block,
                        k_basis=cfg.k_basis,
                        approx_knn=cfg.huge_window_approx_knn,
                        select=select, nbins=nbins)
                # label-free cluster count straight from the normalized-
                # affinity spectrum the Ritz step already computed
                k_host, k_src = self._k_plan(window_true_labels)
                nk = (bspec.eigengap_k_from_spectrum(lam, k_max=self.k_max)
                      if k_src == "eigengap" else jnp.int32(k_host))
                labels = bspec.labels_from_ritz(
                    ritz, nk, key, k_max=self.k_max, n_real=n,
                    background=cfg.background_bucket)
                clusters = np.asarray(labels)
            elif cfg.approach == "DBSCAN_centr":
                from mused_tpu.ops.blocked_dbscan import dbscan_blocked
                labels = dbscan_blocked(np.asarray(reduced), eps=cfg.eps,
                                        min_samples=cfg.min_samples,
                                        block=block)
                clusters, self.prev_centroids, self.prev_centroid_labels = \
                    dbscan.match_centroids(np.asarray(reduced), labels,
                                           self.prev_centroids,
                                           self.prev_centroid_labels)
            else:
                k_host, k_src = self._k_plan(window_true_labels)
                nk = (reduction.eigengap_k(reduced, k_max=self.k_max,
                                           theta=cfg.eigengap_theta)
                      if k_src == "eigengap" else jnp.int32(k_host))
                labels, _ = kmeans.kmeans(reduced, nk, key, k_max=self.k_max)
                if cfg.background_bucket:
                    labels = kmeans.mark_background(reduced, labels,
                                                    k_max=self.k_max)
                clusters = np.asarray(labels)
        if cfg.approach != "DBSCAN_centr":   # centr does its own matching
            with self.timer.span("matching"):
                # the shared one-window matcher (min_overlap/sinkhorn
                # parameters + all-noise fallback live ONLY there) — this
                # was the fourth hand-rolled copy (review r5 finding;
                # centroid matching is forbidden for huge windows in
                # __init__, so no registry is threaded here)
                clusters = match_window_labels(
                    prev_clusters, clusters, cfg,
                    method=self._match_method())
        elif clusters is None or len(clusters) == 0:
            clusters = np.full(cfg.window_size, 0)
        return np.asarray(clusters)

    def _match_method(self) -> str:
        """Positional-matching method: reference dispatch (main.py:105-112)
        under matching="auto", otherwise the configured override."""
        if self.cfg.matching == "auto":
            return "pot" if self.cfg.approach == "sSVDMC_pot" else "hungarian"
        return self.cfg.matching

    def _k_plan(self, window_true_labels) -> tuple[int, str]:
        """Per-window cluster count -> (host value, device ``k_source``).

        cfg.k_estimate selects the source: "labels" reproduces the
        reference's ground-truth-derived count (main.py:41/97 — truth leaks
        into the cluster count, a quirk kept for comparability); "fixed"
        uses cfg.n_clusters_total every window (no labels consulted);
        "eigengap" estimates the count on device from the reduced window's
        spectrum (ops/reduction.eigengap_k) — the host value is then just
        the cap and the device ignores it."""
        if self.cfg.k_estimate == "fixed":
            return self.k_max, "given"
        if self.cfg.k_estimate == "eigengap":
            return self.k_max, "eigengap"
        return int(len(np.unique(window_true_labels))), "given"

    def _stable_feats(self, window_modalities, features) -> np.ndarray | None:
        """Per-row matrix in the (window-rotation-free) input feature space,
        for centroid matching.  None unless cfg.matching="centroid".

        Built from the HOST-side window modalities, not the (prefetcher-
        device_put) feature tensors — np.asarray on those would pull the
        window back over the interconnect every window."""
        if self.centroid_matcher is None:
            return None
        if isinstance(features, (feat.WindowFeatures,
                                 feat.SparseWindowFeatures)):
            raise ValueError(
                "matching='centroid' supports numeric-modality streams "
                "(embeddings etc.); standard SED2012 streams use the "
                "reference positional matching or the DBSCAN_centr approach")
        return stable_feature_matrix(window_modalities)

    # ------------------------------------------------------------------
    def featurize(self, window_modalities, modality_types):
        """Host featurization only (runs in the ingest prefetch thread)."""
        if list(modality_types) == list(("location", "time", "username",
                                         "tags", "text")):
            loc, tim, user, tags, text = window_modalities
            return feat.featurize_window(loc, tim, user, tags, text,
                                         self.cfg.features)
        return tuple(np.asarray(m, np.float32) for m in window_modalities)

    def fuse_from_features(self, feats, modality_types):
        """Device adjacency + fusion from featurized tensors."""
        cfg = self.cfg
        if isinstance(feats, feat.SparseWindowFeatures):
            return _fuse_standard_sparse(
                feats.location, feats.times, feats.user_ids, feats.tags_ids,
                feats.text_ids, feats.text_cnt, feats.tags_valid,
                k_basis=cfg.k_basis, tags_dim=cfg.features.tags_hash_dim,
                text_dim=cfg.features.text_hash_dim)
        if isinstance(feats, feat.WindowFeatures):
            return _fuse_standard(feats.location, feats.times, feats.user_ids,
                                  feats.tags, feats.text, cfg.k_basis,
                                  feats.tags_valid)
        return _fuse_generic(tuple(jnp.asarray(m) for m in feats),
                             k_basis=cfg.k_basis,
                             types=tuple(modality_types))

    def fused_adjacency(self, window_modalities, modality_types):
        """Host featurize + device adjacency/fusion for one window."""
        return self.fuse_from_features(
            self.featurize(window_modalities, modality_types), modality_types)

    # ------------------------------------------------------------------
    def process_window(self, window_modalities, modality_types,
                       window_true_labels, window_index: int,
                       prev_clusters, features=None) -> np.ndarray:
        """One full window: device step + host clustering glue + matching.

        ``features``: optionally pre-featurized tensors (from the ingest
        prefetcher) so the host hashing work overlaps device compute.
        """
        pending = self.dispatch_window(window_modalities, modality_types,
                                       window_true_labels, window_index,
                                       prev_clusters, features=features)
        return self.finalize_window(pending, prev_clusters)

    def dispatch_window(self, window_modalities, modality_types,
                        window_true_labels, window_index: int,
                        prev_clusters, features=None) -> "_PendingWindow":
        """Issue window ``window_index``'s device step WITHOUT pulling its
        results.  The per-window loop pipelines this one window ahead of
        :meth:`finalize_window` (the host label pull + clustering glue +
        matching), so the device computes window w+1 while the host matches
        window w — matching is host-only and feeds nothing back to the
        device, so the lag changes no numerics.  The returned record holds
        the post-window device state (for checkpointing at finalize time,
        after ``self.state`` has already advanced past it)."""
        cfg = self.cfg
        if features is None:
            features = self.featurize(window_modalities, modality_types)
        if cfg.window_size > LARGE_WINDOW_ROWS or cfg.force_blocked_window:
            # the huge-window path drives its own blocked sub-stream with
            # internal pulls; run it to completion (compute-dominated)
            clusters = self._process_window_large(features, modality_types,
                                                  window_true_labels,
                                                  window_index, prev_clusters)
            return _PendingWindow(window_index=window_index, clusters=clusters,
                                  state=self.state)
        verbose = effective_verbose(cfg)
        if verbose:   # small-subset debug oracles (ref main.py:35-37)
            print(f"[window {window_index}] true labels: "
                  f"{np.asarray(window_true_labels)}")

        n_clusters, k_source = self._k_plan(window_true_labels)
        key = jax.random.fold_in(jax.random.key(cfg.seed), window_index)
        stable_feats = self._stable_feats(window_modalities, features)

        if self.mesh is not None:
            from mused_tpu.parallel import sharded as shard_mod
            types = _types_for(features, modality_types)
            with self.timer.span("device_step"):
                new_swfd, new_mb, reduced, labels, r_norm = \
                    shard_mod.sharded_engine_step(
                        self.state.swfd, self.state.minibatch,
                        tuple(jnp.asarray(f) for f in features),
                        jnp.int32(n_clusters), key, approach=cfg.approach,
                        k_basis=cfg.k_basis, reduced_dim=cfg.reduced_dim,
                        k_max=self.k_max, window=cfg.window_size,
                        fd_shrink=cfg.fd_shrink, types=types,
                        tags_dim=cfg.features.tags_hash_dim,
                        text_dim=cfg.features.text_hash_dim, mesh=self.mesh,
                        topology=cfg.merge_topology, k_source=k_source,
                        need_reduced=cfg.approach != "sSpectral" or verbose,
                        eigengap_theta=cfg.eigengap_theta,
                        background=cfg.background_bucket)
                self.state = StreamState(swfd=new_swfd, minibatch=new_mb)
            return _PendingWindow(window_index=window_index, reduced=reduced,
                                  labels=labels, r_norm=r_norm,
                                  stable_feats=stable_feats, verbose=verbose,
                                  state=self.state)

        if verbose:
            # two-dispatch path: the fused-adjacency oracle print
            # (ref main.py:51-53) needs the intermediate matrix on host
            with self.timer.span("fuse"):
                fused = self.fuse_from_features(features, modality_types)
            print(f"[window {window_index}] fused adjacency "
                  f"(sum={float(jnp.sum(fused)):.0f}):\n{np.asarray(fused)}")
            if cfg.approach == "SWFDMC" and self.swfd_R is None:
                self.swfd_R = float(jnp.max(jnp.sum(fused * fused, axis=1)))
            with self.timer.span("device_step"):
                self.state, reduced, labels = _window_step(
                    self.state, fused, jnp.int32(n_clusters), key,
                    approach=cfg.approach, k_basis=cfg.k_basis,
                    reduced_dim=cfg.reduced_dim, k_max=self.k_max,
                    window=cfg.window_size,
                    fd_shrink=cfg.fd_shrink, k_source=k_source,
                    eigengap_theta=cfg.eigengap_theta,
                    background=cfg.background_bucket)
            return _PendingWindow(window_index=window_index, reduced=reduced,
                                  labels=labels, stable_feats=stable_feats,
                                  verbose=verbose, state=self.state)

        # default: fusion + window step in ONE dispatch (halves the
        # per-window call count); the fused matrix stays on device, only
        # its max row norm (the reference's R) comes back
        types = _types_for(features, modality_types)
        with self.timer.span("device_step"):
            self.state, reduced, labels, r_norm = _combined_window_step(
                self.state, tuple(jnp.asarray(f) for f in features),
                jnp.int32(n_clusters), key, approach=cfg.approach,
                k_basis=cfg.k_basis, reduced_dim=cfg.reduced_dim,
                k_max=self.k_max, window=cfg.window_size,
                fd_shrink=cfg.fd_shrink, types=types,
                tags_dim=cfg.features.tags_hash_dim,
                text_dim=cfg.features.text_hash_dim, k_source=k_source,
                need_reduced=cfg.approach != "sSpectral",
                eigengap_theta=cfg.eigengap_theta,
                background=cfg.background_bucket)
        return _PendingWindow(window_index=window_index, reduced=reduced,
                              labels=labels, r_norm=r_norm,
                              stable_feats=stable_feats, verbose=verbose,
                              state=self.state)

    def finalize_window(self, pending: "_PendingWindow",
                        prev_clusters) -> np.ndarray:
        """Pull a dispatched window's results and run the host half
        (clustering glue, matching, fallback).  Must be called in window
        order; ``prev_clusters`` is the previous window's MATCHED labels."""
        if pending.clusters is not None:    # huge-window path: already done
            return pending.clusters
        cfg = self.cfg
        if cfg.approach == "SWFDMC" and self.swfd_R is None \
                and pending.r_norm is not None:
            # reference sizes the sketch with the first window's max squared
            # row norm (main.py:61; pmax'd under SPMD) — parity/diagnostics
            self.swfd_R = float(pending.r_norm)
        if pending.verbose:   # ref main.py:99-103 oracle
            print(f"[window {pending.window_index}] reduced:\n"
                  f"{np.asarray(pending.reduced)}")
        with self.timer.span("device_sync"):
            sync = (pending.labels if cfg.approach not in
                    ("DBSCAN_incr", "DBSCAN_centr") else pending.reduced)
            np.asarray(sync)
        return self._cluster_and_match(pending.reduced, pending.labels,
                                       pending.window_index, prev_clusters,
                                       pending.verbose,
                                       stable_feats=pending.stable_feats)

    def _cluster_and_match(self, reduced, labels, window_index: int,
                           prev_clusters, verbose: bool = False,
                           stable_feats: np.ndarray | None = None) -> np.ndarray:
        """Host clustering glue + cross-window matching + failure fallback —
        shared by the single-chip and SPMD device steps.  ``stable_feats``
        (n, d) feeds centroid matching when cfg.matching="centroid"."""
        cfg = self.cfg
        if cfg.approach == "DBSCAN_incr":
            if self.incr_clusterer is None:
                self.incr_clusterer = dbscan.IncrementalDBSCAN(
                    eps=cfg.eps, min_pts=cfg.min_samples)
            reduced_np = np.asarray(reduced)
            clusters = self.incr_clusterer.insert(reduced_np) \
                .get_cluster_labels(reduced_np)
        elif cfg.approach == "DBSCAN_centr":
            clusters, self.prev_centroids, self.prev_centroid_labels = \
                dbscan.dbscan_centroid_incremental(
                    np.asarray(reduced), self.prev_centroids,
                    self.prev_centroid_labels, eps=cfg.eps,
                    min_samples=cfg.min_samples)
        else:
            clusters = np.asarray(labels)

        # cross-window matching (reference main.py:105-112, min_overlap=3),
        # or the centroid-registry matcher under cfg.matching="centroid"
        if cfg.approach != "DBSCAN_centr":   # centr does its own matching
            with self.timer.span("matching"):
                clusters = match_window_labels(
                    prev_clusters, clusters, cfg,
                    method=self._match_method(),
                    centroid_matcher=self.centroid_matcher,
                    stable_feats=stable_feats)
        elif clusters is None or len(clusters) == 0:
            clusters = np.full(cfg.window_size, 0)
        if verbose:   # ref main.py:107-112 oracle (matched labels)
            print(f"[window {window_index}] matched clusters: "
                  f"{np.asarray(clusters)}")
        return np.asarray(clusters)


def match_window_labels(prev_clusters, labels, cfg, *, method: str,
                        centroid_matcher=None,
                        stable_feats=None) -> np.ndarray:
    """Cross-window matching + clustering-failure fallback for ONE window —
    the single home of the min_overlap=3 / sinkhorn parameters and the
    all-noise fallback (reference main.py:105-116), shared by the
    per-window glue, the offline batched loop, and the serving group
    finalize (review r3 finding #4: three hand-rolled copies drifted)."""
    if centroid_matcher is not None:
        clusters = centroid_matcher.match(stable_feats, np.asarray(labels))
    else:
        clusters = matching.match_clusters(
            prev_clusters, np.asarray(labels), method=method, min_overlap=3,
            sinkhorn_reg=cfg.sinkhorn_reg, sinkhorn_iters=cfg.sinkhorn_iters)
    if clusters is None or len(clusters) == 0:
        # clustering-failure fallback: all-noise window (main.py:114-116)
        clusters = np.full(cfg.window_size, 0)
    return np.asarray(clusters)


def stack_window_features(feats_list: list[tuple]) -> tuple:
    """Stack per-window featurized tuples into one (W, ...) batch per
    component for the scanned multi-window dispatch.  Trimmed token tensors
    can differ in width across the group's windows: pad to the group max
    (ids pad with the -1 invalid sentinel, uint8 counts with 0).  Shared by
    the offline batched loop and the serving group dispatch."""
    def _stack(j):
        parts = [np.asarray(f[j]) for f in feats_list]
        widths = {p.shape[1] for p in parts if p.ndim == 2}
        if len(widths) > 1:
            w = max(widths)
            fill = (-1 if np.issubdtype(parts[0].dtype, np.signedinteger)
                    else 0)   # signed = token ids; uint8 counts pad 0
            parts = [np.pad(p, ((0, 0), (0, w - p.shape[1])),
                            constant_values=fill) if p.shape[1] < w
                     else p for p in parts]
        return np.stack(parts)

    return tuple(_stack(j) for j in range(len(feats_list[0])))


def scanned_types_for(modality_types, features_cfg) -> tuple:
    """Static ``types`` tag for the scanned dispatch given host modality
    types (mirrors _types_for, which keys off the featurized objects)."""
    standard = list(modality_types) == ["location", "time", "username",
                                        "tags", "text"]
    if standard and features_cfg.sparse:
        return ("standard_sparse",)
    if standard:
        return ("standard",)
    return tuple(modality_types)


def stable_feature_matrix(window_modalities) -> np.ndarray:
    """(n, d) input-feature-space matrix for centroid matching — shared by
    the sequential (_stable_feats) and batched (_run_batched_loop) paths so
    the registry sees one feature space."""
    return np.concatenate(
        [np.asarray(m, np.float32).reshape(len(m), -1)
         for m in window_modalities], axis=1)


def process_streaming_data(results, data_modalities, modality_types,
                           window_size, reduced_dim, k_basis, n_clusters_total,
                           seed, approach, complete_true_labels,
                           step_window_ratio, noise_rate, label_mode, sorting,
                           eps, min_samples, cfg: PipelineConfig | None = None,
                           checkpoint_dir: str | None = None,
                           checkpoint_every: int = 1, data_shards: int = 1,
                           merge_topology: str = "allgather",
                           verbose: bool = False, matching: str = "auto",
                           windows_per_batch: int | None = None,
                           k_estimate: str = "labels",
                           eigengap_theta: float = 0.15,
                           background_bucket: bool = False,
                           huge_window_layout: str = "rows",
                           huge_window_col_shards: int = 0,
                           huge_window_cand_fold: bool | None = None):
    """Drop-in equivalent of reference main.py:13-130.

    New over the reference: pass ``checkpoint_dir`` to checkpoint the full
    stream state every ``checkpoint_every`` windows and auto-resume from the
    latest checkpoint found there (window-boundary recovery, SURVEY.md §5.4);
    pass ``data_shards=p`` to run every window step SPMD over a p-device mesh
    (sharded affinity + sketch merge / distributed SVD + psum'd KMeans);
    ``verbose`` enables the reference's small-subset debug oracles.
    """
    total_start = metrics_mod.now_ns()

    subset_size = len(data_modalities[0])
    label_mode_for_k = {2: "binary", 4: "types"}.get(n_clusters_total, "all")
    if cfg is None:
        cfg = PipelineConfig(
            seed=seed, subset_size=subset_size, noise_rate=noise_rate,
            label_mode=label_mode_for_k, sorting=sorting,
            window_size=window_size, reduced_dim=reduced_dim, k_basis=k_basis,
            step_window_ratio=step_window_ratio, approach=approach,
            eps=eps, min_samples=min_samples,
            n_clusters_override=int(n_clusters_total),
            data_shards=data_shards, merge_topology=merge_topology,
            verbose=verbose, matching=matching,
            windows_per_batch=windows_per_batch, k_estimate=k_estimate,
            eigengap_theta=eigengap_theta,
            background_bucket=background_bucket,
            huge_window_layout=huge_window_layout,
            huge_window_col_shards=huge_window_col_shards,
            huge_window_cand_fold=huge_window_cand_fold)

    engine = StreamingEngine(cfg)
    all_clusters: list[np.ndarray] = []
    all_true_labels: list[np.ndarray] = []
    prev_clusters = None
    complete_true_labels = np.asarray(complete_true_labels)
    start_w = 0

    if checkpoint_dir:
        from mused_tpu.utils import checkpoint as ckpt
        latest = ckpt.latest_checkpoint(checkpoint_dir)
        if latest is not None:
            device_state, host = ckpt.load_checkpoint(latest)
            engine.restore(device_state, host)
            start_w = host["next_window"]
            all_clusters = [np.asarray(c) for c in host["all_clusters"]]
            all_true_labels = [np.asarray(t) for t in host["all_true_labels"]]
            prev_clusters = host["prev_clusters"]
            print(f"resumed from {latest} at window {start_w}")

    windows = window_triggers(subset_size, window_size, step_window_ratio)
    todo = list(enumerate(windows))[start_w:]

    # double-buffered ingest: featurize window w+1 on a worker thread while
    # the device computes window w (data/ingest.py)
    from mused_tpu.data.ingest import WindowPrefetcher

    def featurize_at(pos: int):
        _, i = todo[pos]
        lo, hi = i - window_size + 1, i + 1
        return engine.featurize([m[lo:hi] for m in data_modalities],
                                modality_types)

    standard_types = list(modality_types) == ["location", "time", "username",
                                              "tags", "text"]
    batch_w = resolve_windows_per_batch(cfg, standard_types=standard_types,
                                        step_window_ratio=step_window_ratio,
                                        checkpoint_dir=checkpoint_dir,
                                        n_windows=len(todo))
    if cfg.matching == "centroid" and standard_types:
        # fail fast (matching the other config validations) instead of from
        # _stable_feats at the first processed window
        raise ValueError(
            "matching='centroid' supports numeric-modality streams "
            "(embeddings etc.); standard SED2012 streams use the reference "
            "positional matching or the DBSCAN_centr approach")
    # centroid matching works batched on numeric streams (host modality
    # slices feed the registry); the scanned dispatch composes with
    # data_shards>1 via parallel.sharded.sharded_scanned_steps (W sharded
    # steps per dispatch) AND with checkpointing (saves at group boundaries
    # — the device state is only window-consistent between dispatches).
    if batch_w > 1:   # resolver already enforced scanned eligibility
        return _run_batched(results, engine, cfg, todo, data_modalities,
                            modality_types, complete_true_labels, prev_clusters,
                            all_clusters, all_true_labels, window_size,
                            batch_w, subset_size, noise_rate, label_mode,
                            sorting, reduced_dim, k_basis, total_start,
                            checkpoint_dir, checkpoint_every)

    prefetcher = WindowPrefetcher(featurize_at, len(todo), depth=2)

    def _finish(pending) -> None:
        """Pull + match one dispatched window; checkpoint its post-state."""
        nonlocal prev_clusters
        clusters = engine.finalize_window(pending, prev_clusters)
        prev_clusters = clusters
        all_clusters.append(clusters)
        w_done = pending.window_index
        if checkpoint_dir and (w_done + 1) % max(checkpoint_every, 1) == 0:
            from mused_tpu.utils import checkpoint as ckpt
            # pending.state, NOT engine.state: the pipelined loop may have
            # already dispatched the next window into engine.state
            ckpt.save_checkpoint(
                ckpt.checkpoint_name(checkpoint_dir, w_done + 1),
                pending.state,
                {"next_window": w_done + 1,
                 "prev_clusters": prev_clusters,
                 "all_clusters": list(all_clusters),
                 "all_true_labels": list(all_true_labels),
                 **engine.host_snapshot()})

    # depth-2 software pipeline: up to two windows are dispatched ahead of
    # the oldest un-pulled one, so the device computes ahead while the host
    # matches (matching is host-only and feeds nothing back to the device —
    # numerics unchanged) and the pulled window is guaranteed already
    # computed (its pull costs one transfer round trip, not compute wait).
    # verbose keeps the sequential order so the debug-oracle prints don't
    # interleave across windows; checkpointing too — the window step donates
    # its state operand, so window w's saveable state would be invalidated
    # the moment w+1 dispatches.  The huge-window path runs to completion
    # inside dispatch (including matching, which NEEDS the previous window's
    # matched labels), so it must also stay sequential.
    pipelined = (not effective_verbose(cfg) and not checkpoint_dir
                 and window_size <= LARGE_WINDOW_ROWS
                 and not cfg.force_blocked_window)
    from collections import deque
    pending_q: deque = deque()
    try:
        for (w_idx, i), features in zip(todo, prefetcher):
            lo, hi = i - window_size + 1, i + 1
            window_modalities = [m[lo:hi] for m in data_modalities]
            true_labels = complete_true_labels[lo:hi]
            all_true_labels.append(true_labels)

            nxt = engine.dispatch_window(window_modalities, modality_types,
                                         true_labels, w_idx, prev_clusters,
                                         features=features)
            if not pipelined:
                _finish(nxt)
                continue
            # the lag-2 depth already guarantees the window is computed by
            # finalize time, so its pull costs one transfer; starting that
            # transfer early (copy_to_host_async) is untried (ROADMAP)
            pending_q.append(nxt)
            if len(pending_q) > 2:
                _finish(pending_q.popleft())
        while pending_q:
            _finish(pending_q.popleft())
    finally:
        prefetcher.close()

    total_end = metrics_mod.now_ns()
    all_true = np.concatenate(all_true_labels) if all_true_labels else np.empty(0, int)
    all_clus = np.concatenate(all_clusters) if all_clusters else np.empty(0, int)
    return metrics_mod.compute_all_metrics(
        results, subset_size, noise_rate, label_mode, sorting, reduced_dim,
        k_basis, window_size, all_clus, all_true, total_end, total_start)


def _run_batched(results, engine, cfg, todo, data_modalities, modality_types,
                 complete_true_labels, prev_clusters, all_clusters,
                 all_true_labels, window_size, batch_w, subset_size,
                 noise_rate, label_mode, sorting, reduced_dim, k_basis,
                 total_start, checkpoint_dir=None, checkpoint_every=1):
    """Batched-dispatch tumbling stream: W windows per device call
    (_scanned_window_steps), host matching chains the labels afterwards."""
    types = scanned_types_for(modality_types, cfg.features)
    standard = types[0] in ("standard", "standard_sparse")

    from mused_tpu.data.ingest import WindowPrefetcher

    def group_at(gpos: int):
        """Featurize + host-stack + device_put one whole W-window group.
        Runs in a prefetch worker so the hashing, the tail-width padding,
        the stacking AND the transfer all overlap device compute — the main
        loop sees ready device tensors and issues zero eager array ops."""
        group = todo[gpos * batch_w:(gpos + 1) * batch_w]
        feats_list = []
        for _, i in group:
            lo, hi = i - window_size + 1, i + 1
            f = engine.featurize([m[lo:hi] for m in data_modalities],
                                 modality_types)
            feats_list.append(tuple(f))
        # pad the stream's tail group by repeating the last window so the
        # scanned step compiles for ONE static W (extra outputs dropped;
        # state pollution is irrelevant past stream end)
        while len(feats_list) < batch_w:
            feats_list.append(feats_list[-1])

        # host arrays out — the prefetcher's _task does the device_put
        return stack_window_features(feats_list)

    n_groups = -(-len(todo) // batch_w)
    # depth=2 groups: the in-flight group and the next one (the dispatch-
    # ahead pipeline consumes a full group while the previous is pulled);
    # 2 workers let two groups featurize concurrently (C hashing and numpy
    # release the GIL)
    prefetcher = WindowPrefetcher(group_at, n_groups, depth=2, workers=2)
    groups_iter = iter(prefetcher)

    try:
        return _run_batched_loop(
            results, engine, cfg, todo, groups_iter, complete_true_labels,
            prev_clusters, all_clusters, all_true_labels, window_size,
            batch_w, subset_size, noise_rate, label_mode, sorting,
            reduced_dim, k_basis, total_start, types, standard,
            data_modalities, checkpoint_dir, checkpoint_every)
    finally:
        prefetcher.close()


def _run_batched_loop(results, engine, cfg, todo, groups_iter,
                      complete_true_labels, prev_clusters, all_clusters,
                      all_true_labels, window_size, batch_w, subset_size,
                      noise_rate, label_mode, sorting, reduced_dim, k_basis,
                      total_start, types, standard, data_modalities,
                      checkpoint_dir=None, checkpoint_every=1):
    def _finalize(rec) -> None:
        """Pull one dispatched group's labels + match + (maybe) checkpoint."""
        nonlocal prev_clusters
        group, n_real, labels_list, batch_labels, r_norms = rec
        with engine.timer.span("batched_pull"):
            batch_labels = np.asarray(batch_labels)
        if cfg.approach == "SWFDMC" and engine.swfd_R is None:
            # reference sizes the sketch with the FIRST window's max
            # squared row norm (main.py:61) — diagnostic parity the
            # batched paths previously skipped
            engine.swfd_R = float(np.asarray(r_norms)[0])
        method = engine._match_method()
        for pos in range(n_real):
            stable = None
            if engine.centroid_matcher is not None:
                _, i = group[pos]
                lo, hi = i - window_size + 1, i + 1
                stable = stable_feature_matrix([m[lo:hi]
                                                for m in data_modalities])
            prev_clusters = match_window_labels(
                prev_clusters, batch_labels[pos], cfg, method=method,
                centroid_matcher=engine.centroid_matcher,
                stable_feats=stable)
            all_clusters.append(prev_clusters)
            all_true_labels.append(labels_list[pos])

        # checkpoint at the group boundary (engine.state is only
        # window-consistent between dispatches); padded tail groups are the
        # stream's end, where a save adds nothing
        last_w = group[n_real - 1][0]
        due = any((w + 1) % max(checkpoint_every, 1) == 0
                  for w, _ in group[:n_real])
        if checkpoint_dir and due and n_real == batch_w:
            from mused_tpu.utils import checkpoint as ckpt
            ckpt.save_checkpoint(
                ckpt.checkpoint_name(checkpoint_dir, last_w + 1),
                engine.state,
                {"next_window": last_w + 1,
                 "prev_clusters": prev_clusters,
                 "all_clusters": list(all_clusters),
                 "all_true_labels": list(all_true_labels),
                 **engine.host_snapshot()})

    # dispatch-ahead pipeline: group g+1's device step is dispatched BEFORE
    # group g's labels are pulled, so the device starts the next W windows
    # while the host blocks on (and then matches) the previous group.
    # Matching is host-only and feeds nothing back to the device, so the lag
    # changes no numerics.  Checkpointing keeps the sequential order: the
    # scanned step donates its state operands, so the saveable state of
    # group g is invalidated the moment group g+1 dispatches.
    pipelined = not checkpoint_dir
    pending = None
    for base in range(0, len(todo), batch_w):
        group = todo[base:base + batch_w]
        labels_list = []
        for _, i in group:
            lo, hi = i - window_size + 1, i + 1
            labels_list.append(complete_true_labels[lo:hi])
        # group padding mirrors the prefetcher's (repeat the last window so
        # the scanned step compiles for ONE static W; extra outputs dropped)
        n_real = len(group)
        while len(labels_list) < batch_w:
            labels_list.append(labels_list[-1])
            group = group + group[-1:]
        # featurized + stacked + device-resident, from the prefetch worker
        feats_batch = next(groups_iter)
        k_source = engine._k_plan(labels_list[0])[1]
        n_clusters = jnp.asarray([engine._k_plan(t)[0] for t in labels_list],
                                 jnp.int32)
        keys = jax.vmap(lambda w: jax.random.fold_in(
            jax.random.key(cfg.seed), w))(jnp.asarray([w for w, _ in group]))
        with engine.timer.span("batched_device_step"):
            # scanned dispatch, SPMD-composed when a mesh is configured —
            # the shared helper is the single spelling of the call
            batch_labels, r_norms = scanned_group_dispatch(
                engine, feats_batch, n_clusters, keys, types=types,
                k_source=k_source)
        rec = (group, n_real, labels_list, batch_labels, r_norms)
        if not pipelined:
            _finalize(rec)
            continue
        if pending is not None:
            _finalize(pending)
        pending = rec
    if pending is not None:
        _finalize(pending)

    total_end = metrics_mod.now_ns()
    all_true = np.concatenate(all_true_labels) if all_true_labels else np.empty(0, int)
    all_clus = np.concatenate(all_clusters) if all_clusters else np.empty(0, int)
    return metrics_mod.compute_all_metrics(
        results, subset_size, noise_rate, label_mode, sorting, reduced_dim,
        k_basis, window_size, all_clus, all_true, total_end, total_start)


def window_triggers(subset_size: int, window_size: int,
                    step_window_ratio: int) -> list[int]:
    """Stream indices i at which a window fires (reference main.py:32):
    full window and (i+1)*step_window_ratio % window_size == 0."""
    out = []
    for i in range(subset_size):
        if i + 1 >= window_size and ((i + 1) * step_window_ratio) % window_size == 0:
            out.append(i)
    return out
