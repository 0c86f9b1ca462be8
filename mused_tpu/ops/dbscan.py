"""Density clustering family: DBSCAN / HDBSCAN / incremental variants.

Replaces the reference's sklearn DBSCAN, hdbscan.HDBSCAN, incdbscan
IncrementalDBSCAN, and the centroid-matched incremental DBSCAN (reference
matrix_operations.py:235-243, 265-298; main.py:87-91).

Device/host split:
  * all O(n^2) geometry (distance matrices, eps-graphs, core-point degrees,
    mutual-reachability) runs on device as masked matmuls;
  * DBSCAN's connected components run on device as a min-label propagation
    ``lax.while_loop`` (label lattice converges in graph-diameter steps);
  * HDBSCAN's MST + condensed-tree extraction is irreducibly sequential —
    the batch path runs Prim over the IMPLICIT mutual-reachability graph on
    host (mutual reachability rows are one BLAS pass each; nothing (n, n)
    crosses the host<->device boundary), and huge inputs use the device
    Boruvka in ops/blocked_hdbscan.

Label ids are numbered by each cluster's MINIMUM member row index (border
points included) — sklearn instead numbers by core-point discovery order,
so the two orderings can permute — and border-point ties may attach to a
different adjacent cluster than sklearn's insertion order.  Both are
documented deviations: downstream metrics are permutation-invariant or
matched (SURVEY.md §2.4).  Noise is -1.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .kmeans import _sq_dists
from mused_tpu.utils.runtime import platform_paths


def _first_occurrence_compaction(roots: jax.Array, is_clustered: jax.Array) -> jax.Array:
    """Relabel root row-ids to consecutive ints by first occurrence; -1 noise."""
    n = roots.shape[0]
    arange = jnp.arange(n)
    safe_roots = jnp.where(is_clustered, roots, 0)
    first = jnp.full((n,), n, jnp.int32).at[safe_roots].min(
        jnp.where(is_clustered, arange, n).astype(jnp.int32))
    first_of = first[safe_roots]                      # first row index of my cluster
    is_rep = is_clustered & (arange == first_of)
    rank = jnp.cumsum(is_rep.astype(jnp.int32)) - 1   # rank of rep at its own row
    new = rank[first_of]
    return jnp.where(is_clustered, new, -1).astype(jnp.int32)


@jax.jit
def dbscan_labels(x: jax.Array, eps: jax.Array, min_samples: jax.Array) -> jax.Array:
    """DBSCAN on (n, d) points -> (n,) int32 labels, noise = -1.

    Device algorithm: eps-graph + core mask, then min-label propagation over
    the core-core subgraph (connected components), then border attachment to
    the minimum-labeled core neighbor.
    """
    n = x.shape[0]
    d2 = _sq_dists(x.astype(jnp.float32), x.astype(jnp.float32))
    within = d2 <= (eps * eps)                       # includes self
    core = jnp.sum(within, axis=1) >= min_samples
    core_edge = within & core[:, None] & core[None, :]

    labels0 = jnp.where(core, jnp.arange(n), n).astype(jnp.int32)

    def body(state):
        labels, _ = state
        neigh_min = jnp.min(jnp.where(core_edge, labels[None, :], n), axis=1)
        new = jnp.minimum(labels, neigh_min.astype(jnp.int32))
        return new, jnp.any(new != labels)

    labels, _ = jax.lax.while_loop(lambda s: s[1], body, (labels0, jnp.asarray(True)))

    # border points: non-core within eps of a core point -> that root's label
    border_min = jnp.min(jnp.where(within & core[None, :], labels[None, :], n), axis=1)
    is_border = (~core) & (border_min < n)
    roots = jnp.where(core, labels, jnp.where(is_border, border_min, 0)).astype(jnp.int32)
    clustered = core | is_border
    return _first_occurrence_compaction(roots, clustered)


def dbscan(data, eps: float = 0.5, min_samples: int = 5) -> np.ndarray:
    """Host-facing DBSCAN (reference matrix_operations.py:235-238)."""
    x = jnp.asarray(np.asarray(data, np.float32))
    return np.asarray(dbscan_labels(x, jnp.float32(eps), jnp.int32(min_samples)))


# ---------------------------------------------------------------------------
# HDBSCAN (batch): host Prim MST over the implicit mutual-reachability graph
# ---------------------------------------------------------------------------

class _UnionFind:
    def __init__(self, n):
        self.parent = list(range(n))

    def find(self, a):
        while self.parent[a] != a:
            self.parent[a] = self.parent[self.parent[a]]
            a = self.parent[a]
        return a

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra
        return ra


# Above this row count the full (n, n) squared-distance matrix (f32) is not
# materialized on host: ~1 GiB at the cap.  Beyond it Prim recomputes each
# row as one BLAS matvec (CPU) or the caller routes to the device Boruvka.
_PRIM_DENSE_CAP = 16_384


def _prim_mst_mreach(x: np.ndarray, min_samples: int) -> list[tuple]:
    """Exact MST of the implicit mutual-reachability graph, host numpy.

    Replaces the round-4 dense route (device (n, n) mutual reachability +
    full row sort + scipy dense MST: 58 s at n=8000 on the CPU host).  Prim
    over the IMPLICIT graph is O(n^2 d) with one row of
    max(core_i, core_u, d_iu) per step: the (n, n) matrix is either built
    once in f32 blocks (n <= _PRIM_DENSE_CAP, so core extraction and every
    Prim row are memory lookups) or rematerialized per step as one BLAS
    matvec.  ~2.3 s at n=8000 — faster than sklearn's KDTree Boruvka in
    d=50, with zero device round-trips (the reduced embedding is already
    host-side in the batch engine).  Duplicate points (zero distances) need
    no special casing, unlike scipy's explicit-zero-drops-the-edge quirk.
    """
    n = len(x)
    sq = np.einsum("ij,ij->i", x, x)
    # clamp like the old jitted path's jnp.clip(min_samples-1, 0, n-1):
    # min_samples<=1 degrades to core=0 (a plain distance MST), not a
    # kth=-1 partition picking each row's MAXIMUM distance
    k = min(max(min_samples, 1), n)

    mreach = None
    core = np.empty(n, np.float32)
    blk = max(1, min(n, (1 << 24) // max(n, 1)))       # ~64 MB gram slabs
    if n <= _PRIM_DENSE_CAP:
        mreach = np.empty((n, n), np.float32)
    for s in range(0, n, blk):
        e = min(s + blk, n)
        g = x[s:e] @ x.T
        g *= -2.0
        g += sq[s:e, None]
        g += sq[None, :]
        np.maximum(g, 0.0, out=g)
        core[s:e] = np.partition(g, k - 1, axis=1)[:, k - 1]
        if mreach is not None:
            np.sqrt(g, out=g)
            mreach[s:e] = g
    np.sqrt(core, out=core)
    if mreach is not None:
        # fold the core distances in once, so every Prim row is a plain view
        np.maximum(mreach, core[None, :], out=mreach)
        np.maximum(mreach, core[:, None], out=mreach)

    live = np.ones(n, bool)                 # not yet in the tree
    best_w = np.full(n, np.inf, np.float32)  # cheapest edge into the tree
    best_src = np.zeros(n, np.int64)
    upd = np.empty(n, bool)
    edges: list[tuple] = []
    u = 0
    live[0] = False
    for _ in range(n - 1):
        if mreach is not None:
            w = mreach[u]
        else:
            d2 = sq[u] + sq - 2.0 * (x @ x[u])
            np.maximum(d2, 0.0, out=d2)
            w = np.sqrt(d2, out=d2)
            np.maximum(w, core, out=w)
            if core[u] > 0.0:
                np.maximum(w, core[u], out=w)
        np.less(w, best_w, out=upd)
        upd &= live
        best_w[upd] = w[upd]
        best_src[upd] = u
        v = int(np.argmin(best_w))
        edges.append((float(best_w[v]), int(best_src[v]), v))
        live[v] = False
        best_w[v] = np.inf
        u = v
    return edges


def hdbscan(data, min_cluster_size: int = 5, min_samples: int = 2) -> np.ndarray:
    """HDBSCAN with excess-of-mass extraction (reference matrix_operations.py:240-243).

    Host Prim MST over the implicit mutual-reachability graph -> single-
    linkage merge tree -> condensed tree (min_cluster_size) -> eom selection
    -> labels.  Validated against sklearn.cluster.HDBSCAN in
    tests/test_dbscan.py.  Above _PRIM_DENSE_CAP rows, on a platform whose
    paths say so (utils.runtime.platform_paths().device_hdbscan), the
    sweeps go to the device Boruvka (ops/blocked_hdbscan) instead — same
    MST, same extraction.
    """
    x = np.asarray(data, np.float32)
    n = len(x)
    if n == 0:
        return np.empty(0, np.int64)
    if n == 1:
        return np.array([-1], np.int64)
    if n > _PRIM_DENSE_CAP and platform_paths().device_hdbscan:
        from mused_tpu.ops.blocked_hdbscan import hdbscan_blocked
        return hdbscan_blocked(x, min_cluster_size=min_cluster_size,
                               min_samples=min_samples)
    edges = sorted(_prim_mst_mreach(x, min_samples))
    return _extract_labels(edges, n, min_cluster_size)


def _extract_labels(edges, n: int, min_cluster_size: int) -> np.ndarray:
    """Single-linkage merge tree -> condensed tree -> eom labels, from sorted
    MST edges (w, a, b).  Shared by the dense and blocked (Boruvka) paths."""
    # single-linkage merge tree; internal nodes get ids >= n
    uf = _UnionFind(2 * n - 1)
    node_of_root = list(range(n))
    size = [1] * n + [0] * (n - 1)
    children: list[tuple | None] = [None] * (2 * n - 1)
    next_node = n
    for dist, a, b in edges:
        ra, rb = uf.find(int(a)), uf.find(int(b))
        na, nb = node_of_root[ra], node_of_root[rb]
        r = uf.union(ra, rb)
        node_of_root[r] = next_node
        size[next_node] = size[na] + size[nb]
        children[next_node] = (na, nb, dist)
        next_node += 1
    root = next_node - 1

    def subtree_points(node):
        out, stack = [], [node]
        while stack:
            m = stack.pop()
            if m < n:
                out.append(m)
            else:
                a, b, _ = children[m]
                stack.extend((a, b))
        return out

    # Condensed tree walk.  For each cluster c we record:
    #   point_out[p] = (c, lambda) for points that fall out of c directly
    #   cluster_parent/child links and birth lambdas for true splits
    lam_birth = {root: 0.0}
    cluster_parent: dict[int, int] = {}
    child_clusters: dict[int, list[int]] = {root: []}
    point_parent: dict[int, int] = {}
    point_out_lambda = np.zeros(n)

    stack = [root]
    while stack:
        c = stack.pop()
        child_clusters.setdefault(c, [])
        node_stack = [c]
        while node_stack:
            m = node_stack.pop()
            if m < n:
                # leaf point directly inside c (only when min_cluster_size==1
                # or c itself is tiny); falls out "never" -> lambda inf capped later
                point_parent[m] = c
                point_out_lambda[m] = np.inf
                continue
            a, b, dist = children[m]
            lam = 1.0 / dist if dist > 0 else np.inf
            big_a = size[a] >= min_cluster_size
            big_b = size[b] >= min_cluster_size
            if big_a and big_b:
                # true split: both sides become child clusters of c
                for ch in (a, b):
                    lam_birth[ch] = lam
                    cluster_parent[ch] = c
                    child_clusters[c].append(ch)
                    stack.append(ch)
            else:
                for side, big in ((a, big_a), (b, big_b)):
                    if big:
                        node_stack.append(side)
                    else:
                        for p in subtree_points(side):
                            point_parent[p] = c
                            point_out_lambda[p] = lam

    # cap ALL inf lambdas (point out-lambdas AND cluster birth lambdas) at
    # one global finite scale: zero-distance TRUE splits (>= 2*mcs
    # coincident duplicate rows) otherwise give nested inf-born clusters
    # whose stability sums inf - inf = nan and corrupt the eom selection
    finite = point_out_lambda[np.isfinite(point_out_lambda)]
    finite_births = [v for v in lam_birth.values() if np.isfinite(v)]
    cap = max(finite.max() if len(finite) else 1.0,
              max(finite_births) if finite_births else 1.0)
    point_out_lambda = np.where(np.isfinite(point_out_lambda),
                                point_out_lambda, cap)
    for c, v in lam_birth.items():
        if not np.isfinite(v):
            lam_birth[c] = cap

    # stability(c) = sum_points (lambda_out - birth) + sum_children (birth_child - birth)*size_subtree(child)
    stability: dict[int, float] = {c: 0.0 for c in child_clusters}
    for p, c in point_parent.items():
        stability[c] += max(point_out_lambda[p] - lam_birth[c], 0.0)
    for ch, par in cluster_parent.items():
        # size[] already carries every merge node's leaf count — O(1) lookup
        stability[par] += max(lam_birth[ch] - lam_birth[par], 0.0) * size[ch]

    # excess-of-mass: bottom-up, a cluster wins if its stability beats the
    # sum of its children's winning stabilities (root never selected).
    # Iterative post-order: a caterpillar hierarchy nests one true split
    # per shed subcluster, so recursion depth would be ~n/mcs and blow the
    # Python frame limit at blocked-path scales (review r5 finding).
    selected: set[int] = set()
    win_sum: dict[int, float] = {}       # c -> subtree winning stability
    post: list[int] = []
    stack_ = [root]
    while stack_:
        c = stack_.pop()
        post.append(c)
        stack_.extend(child_clusters.get(c, []))
    for c in reversed(post):             # children before parents
        kids = child_clusters.get(c, [])
        if not kids:
            if c != root:
                selected.add(c)
            win_sum[c] = stability[c]
            continue
        kid_sum = sum(win_sum[k] for k in kids)
        if c != root and stability[c] >= kid_sum:
            # unselect all descendants: walk c's condensed subtree once
            walk = list(kids)
            while walk:
                m = walk.pop()
                selected.discard(m)
                walk.extend(child_clusters.get(m, []))
            selected.add(c)
            win_sum[c] = stability[c]
        else:
            win_sum[c] = kid_sum

    # labeling: walk each point's condensed parent chain up to the nearest
    # selected cluster (hdbscan do_labelling semantics); root -> noise
    labels = np.full(n, -1, np.int64)
    for p in range(n):
        c = point_parent.get(p, root)
        while c != root and c not in selected:
            c = cluster_parent[c]
        if c in selected:
            labels[p] = c

    out = np.full(n, -1, np.int64)
    mapping: dict[int, int] = {}
    for i in range(n):
        if labels[i] >= 0:
            out[i] = mapping.setdefault(labels[i], len(mapping))
    return out


# ---------------------------------------------------------------------------
# incremental variants
# ---------------------------------------------------------------------------

@jax.jit
def _incdb_place(buf: jax.Array, new: jax.Array, start: jax.Array) -> jax.Array:
    """Write a new point batch into the capacity-padded device buffer."""
    return jax.lax.dynamic_update_slice(buf, new, (start, jnp.int32(0)))


@jax.jit
def _incdb_counts(buf: jax.Array, n_valid: jax.Array, new: jax.Array,
                  eps: jax.Array):
    """(counts, masked d2): exact |N_eps| per new row over the valid prefix
    (self included) AND the masked distance matrix, kept ON DEVICE so the
    follow-up top-k (whose k depends on counts.max(), a host value) reuses
    it — the O(n_new * N * d) pairwise matmul runs once per insert, not
    twice (review r5 finding)."""
    d2 = _sq_dists(new, buf)
    valid = jnp.arange(buf.shape[0])[None, :] < n_valid
    counts = jnp.sum(valid & (d2 <= eps * eps), axis=1).astype(jnp.int32)
    return counts, jnp.where(valid, d2, jnp.inf)


@functools.partial(jax.jit, static_argnames=("k",))
def _incdb_topk(d2_masked: jax.Array, k: int):
    """k nearest valid points per new row from the masked distance matrix
    -> (d2 vals, global indices).  With k >= that row's within-eps count,
    the k nearest provably contain every within-eps neighbor (all of them
    are nearer than any non-member)."""
    neg, idx = jax.lax.top_k(-d2_masked, k)
    return -neg, idx


_FALLBACK_CAP = 8192    # round-1 bounded default; caps the no-native fallback


class IncrementalDBSCAN:
    """insert/get_cluster_labels contract of the incdbscan library used at
    reference main.py:87-91, rebuilt EXACTLY for the insertion-only stream.

    Default (``max_buffer=None``) is exact incremental DBSCAN over everything
    ever inserted, with the device/host split: the O(n_new * N * d) geometry
    runs on device (pairwise matmuls into a capacity-doubling resident
    buffer + exact eps-neighbor extraction via adaptive ``top_k`` whose k is
    the batch's max within-eps count, padded to a power of two to bound
    recompiles), while the sequential cluster structure — monotone union-find
    over core transitions — lives in the native C++ core (incdbscan.cpp).
    Core status and component merges are monotone under insertion, so labels
    equal batch DBSCAN over the full inserted set regardless of how the
    stream was batched (border-point ties may attach to a different adjacent
    cluster than sklearn's scan order; same caveat as ``dbscan_labels``).
    Without the native library the fallback re-clusters the FULL buffer on
    device — same exact semantics, O(N^2) per insert instead of O(n_new*N).

    ``max_buffer=k`` keeps the legacy memory-capped mode: re-cluster the last
    k points, evicting the oldest (an approximation once the stream exceeds
    the cap — the pre-round-2 default, still useful to bound device work).
    The no-native fallback is exact only up to ``_FALLBACK_CAP`` points, then
    behaves like the capped mode (full-buffer DBSCAN memory is O(N^2)).
    """

    def __init__(self, eps: float, min_pts: int, max_buffer: int | None = None):
        self.eps = float(eps)
        self.min_pts = int(min_pts)
        self.max_buffer = None if max_buffer is None else int(max_buffer)
        self._buf: np.ndarray | None = None       # host copy (checkpointing)
        self._labels: np.ndarray | None = None
        self._handle = None                        # native union-find core
        self._handle_tried = False
        self._dev_buf: jax.Array | None = None     # capacity-padded points
        self._n = 0                                # valid rows in _dev_buf

    # -- exact-mode internals ------------------------------------------
    def _native_handle(self):
        if not self._handle_tried:
            self._handle_tried = True
            from mused_tpu import native
            self._handle = native.IncDBHandle.create(self.min_pts)
        return self._handle

    def _ensure_capacity(self, need: int, d: int) -> None:
        cap = self._dev_buf.shape[0] if self._dev_buf is not None else 0
        if need <= cap:
            return
        new_cap = max(256, 1 << (need - 1).bit_length())
        grown = jnp.zeros((new_cap, d), jnp.float32)
        if self._dev_buf is not None and self._n:
            grown = _incdb_place(grown, self._dev_buf[:self._n], jnp.int32(0))
        self._dev_buf = grown

    def _insert_exact(self, pts: np.ndarray) -> None:
        n_new, d = pts.shape
        n_old = self._n
        self._ensure_capacity(n_old + n_new, d)
        new_dev = jnp.asarray(pts)
        self._dev_buf = _incdb_place(self._dev_buf, new_dev, jnp.int32(n_old))
        self._n = n_old + n_new
        n_valid = jnp.int32(self._n)
        eps = jnp.float32(self.eps)
        counts_dev, d2_masked = _incdb_counts(self._dev_buf, n_valid,
                                              new_dev, eps)
        counts = np.asarray(counts_dev)
        k = int(counts.max(initial=1))
        k = min(max(32, 1 << (k - 1).bit_length()), self._n)
        vals, idx = _incdb_topk(d2_masked, k)
        vals = np.asarray(vals)
        idx = np.asarray(idx)
        gids = np.arange(n_old, self._n, dtype=np.int32)[:, None]
        # keep only earlier-id neighbors: delivers each unordered pair once
        # (old-new pairs here; new-new pairs from the higher id's row)
        mask = (vals <= np.float32(self.eps) * np.float32(self.eps)) & (idx < gids)
        self._handle.insert(n_new, np.broadcast_to(gids, idx.shape)[mask],
                            idx[mask])

    # -- public contract ------------------------------------------------
    def insert(self, points) -> "IncrementalDBSCAN":
        pts = np.atleast_2d(np.asarray(points, np.float32))
        self._buf = pts if self._buf is None else np.concatenate([self._buf, pts])
        if self.max_buffer is not None:           # legacy bounded mode
            if len(self._buf) > self.max_buffer:
                self._buf = self._buf[-self.max_buffer:]
            self._labels = dbscan(self._buf, eps=self.eps,
                                  min_samples=self.min_pts)
            return self
        if self._native_handle() is not None:
            self._insert_exact(pts)
            self._labels = None                   # recomputed lazily
        else:
            # exact-by-recluster fallback (no native library): full-buffer
            # DBSCAN is exact but O(N^2) device memory per insert, so beyond
            # the round-1 bounded default it reverts to that capped mode
            # rather than growing toward an OOM at corpus scale
            if len(self._buf) > _FALLBACK_CAP:
                self._buf = self._buf[-_FALLBACK_CAP:]
            self._labels = dbscan(self._buf, eps=self.eps,
                                  min_samples=self.min_pts)
        return self

    def get_cluster_labels(self, points) -> np.ndarray:
        # same shape normalization as insert(): a bare (d,) point is ONE
        # record, not d of them (a raw len() returned d labels for it)
        k = len(np.atleast_2d(np.asarray(points)))
        if self._labels is None:
            self._labels = self._handle.labels()
        if k > len(self._labels):
            raise ValueError(
                f"queried {k} labels but only {len(self._labels)} points "
                "are retained (bounded max_buffer/fallback mode evicted "
                "older rows)")
        return np.asarray(self._labels[-k:])

    # -- checkpointing ---------------------------------------------------
    def snapshot(self) -> dict:
        """Picklable state.  Exact mode stores only the inserted points:
        labels are batching-invariant, so restore re-inserts them in one
        batch and reaches the identical structure."""
        return {"eps": self.eps, "min_pts": self.min_pts,
                "max_buffer": self.max_buffer, "buf": self._buf,
                "labels": self._labels if self.max_buffer is not None else None}

    @classmethod
    def from_snapshot(cls, snap: dict) -> "IncrementalDBSCAN":
        inc = cls(snap["eps"], snap["min_pts"], snap.get("max_buffer"))
        if snap.get("buf") is not None and len(snap["buf"]):
            if inc.max_buffer is not None:
                inc._buf = snap["buf"]
                inc._labels = snap["labels"]
                if inc._labels is None:
                    inc._labels = dbscan(inc._buf, eps=inc.eps,
                                         min_samples=inc.min_pts)
            else:
                inc.insert(snap["buf"])
        return inc


def match_centroids(data: np.ndarray, labels: np.ndarray, previous_centroids,
                    previous_labels):
    """Centroid matching across windows (reference matrix_operations.py:278-298):
    each new cluster centroid maps to the nearest previous centroid and
    inherits its label.

    Returns (labels, new_centroids, centroid_labels) where
    ``centroid_labels[i]`` is the FINAL (post-remap) label of
    ``new_centroids[i]`` — the pair the NEXT window's lookup indexes.  The
    reference returned the unique of the remapped labels here (noise -1
    included), which is misaligned with the centroid array whenever a
    window has noise: the next window's ``prev_labels[old]`` then shifts
    every inherited id by one and can relabel a real cluster as noise
    (review r5 finding; the reference's own DBSCAN_centr path never runs —
    see dbscan_centroid_incremental — so this follows the evident intent,
    like the rest of this approach)."""
    unique_clusters = [c for c in np.unique(labels) if c != -1]
    new_centroids = np.array([data[labels == c].mean(axis=0) for c in unique_clusters]) \
        if unique_clusters else np.empty((0, data.shape[1]), np.float32)

    mapping = {}
    if previous_centroids is not None and len(previous_centroids) > 0 and len(new_centroids) > 0:
        diff = new_centroids[:, None, :] - np.asarray(previous_centroids)[None, :, :]
        matches = np.argmin(np.linalg.norm(diff, axis=-1), axis=1)
        prev_labels = np.asarray(previous_labels)
        # positions in unique_clusters ARE the label values (dbscan labels
        # are first-occurrence-compacted 0..k-1), matching the reference's
        # enumerate-keyed mapping
        mapping = {new: (prev_labels[old] if old < len(prev_labels) else -1)
                   for new, old in enumerate(matches)}
        labels = np.array([mapping[l] if l in mapping else l for l in labels])
    centroid_labels = np.array([mapping.get(int(c), int(c))
                                for c in unique_clusters], np.int64)
    return labels, new_centroids, centroid_labels


def dbscan_centroid_incremental(data, previous_centroids, previous_labels,
                                eps: float = 0.5, min_samples: int = 5):
    """Per-window DBSCAN + centroid matching to the previous window
    (reference matrix_operations.py:265-298).

    The reference's own DBSCAN_centr dispatch cannot actually run: it
    overwrites ``prev_clusters`` with the (k,) label UNIQUES
    (main.py:94 unpacks new_labels into prev_clusters) and then feeds
    them to the outer ``match_clusters`` against the (window,) labels —
    ``(prev_clusters == p) & (new_clusters == n)`` broadcasts (k,) vs
    (window,) and raises at the first window (verified head-to-head,
    REFPARITY.md; the approach is commented out of the reference's own
    list, main.py:300).  We reproduce the documented centroid-re-map
    semantics and skip the outer matcher for this approach (the re-map IS
    the matching), which is the evident intent."""
    data = np.asarray(data, np.float32)
    if data.ndim != 2:
        return None, previous_centroids, previous_labels
    labels = dbscan(data, eps=eps, min_samples=min_samples)
    return match_centroids(data, labels, previous_centroids, previous_labels)
