"""Smoke test of the streaming pipeline on an NVIDIA GPU.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --multichip  # four cards: the mesh phase only

Phases (one process; any failure exits non-zero):

  device      refuse to run unless JAX's first device is a GPU; print the
              card's name and power limit, the JAX version, the cache dir
  flagship    api.prepare_modalities + api.process_streaming_data at the
              reference defaults (150,000 rows, window 2000, reduced_dim 50,
              k_basis 50, noise 0.95, binary labels) for SWFDMC and sSVDMC
  serving     serving.StreamDetector (eigengap k) over the first 10 windows
              pushed in uneven chunks
  huge        one 98,304-row SWFDMC window through the blocked sweep
  compare     the first 8 flagship windows on the GPU and on the host CPU:
              per-modality kNN edges and the engine's fused adjacency, the
              FD sketch's covariance error, per-window labels; the GPU's
              scanned group at the default W against per-window dispatch;
              one full-width huge-window row block (binned selection) and a
              16,384-row binned + candidate-fold sketch on both devices
  gpu tests   the tests marked ``gpu`` (pytest, in this process)
  multichip   (--multichip only) data_shards=4 SPMD for SWFDMC (all_gather
              and ring sketch merges, each held to the FD bound) and sSVDMC,
              and the huge-window "columns" layout — each against the same
              run on one card

These are smoke numbers, not a benchmark.  The last line of standard output
is one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
Data is synthetic and made from a seed.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

# The comparison phase runs the same functions on the host CPU in this
# process, so the CPU backend must be available next to the GPU.
if os.environ.get("JAX_PLATFORMS") and "cpu" not in os.environ["JAX_PLATFORMS"]:
    os.environ["JAX_PLATFORMS"] += ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))

# reference defaults (reference main.py:303-313; mused_tpu/main.py)
SUBSET, WINDOW, REDUCED_DIM, K_BASIS, NOISE = 150_000, 2000, 50, 50, 0.95
HUGE_WINDOW = 98_304          # 48 blocks of 2048, the 100k-window regime
HUGE_BLOCK = 2048
COMPARE_WINDOWS = 8           # one whole scanned group at W=8
HUGE_FOLD_ROWS = 16_384       # 8 blocks: the fold compared with the CPU

# Tolerances of the GPU-against-CPU comparison, and why:
# * kNN edges: every similarity is exact or HIGHEST-precision f32 on both
#   backends, and top_k breaks ties by the lowest index on both, so edges
#   can differ only where two candidates tie to the last ulp — the
#   haversine's transcendentals are not bit-identical across backends.  A
#   flip swaps one edge for its equal-distance twin, so at least 99% of the
#   edges of every modality must be identical (Jaccard of the edge sets).
EDGE_AGREEMENT_MIN = 0.99
# * FD sketch: both devices fold the same fused matrix with the same
#   Rayleigh-Ritz shrink; the GPU's DEFAULT-precision probe products (TF32)
#   pick a slightly different subspace, which moves the covariance error
#   by a few per cent at most.  Both must stay within the FD guarantee
#   ||A||_F^2 / ell, and within 10% of each other.
SKETCH_ERR_REL_MAX = 0.10
# * labels: KMeans on the transposed sketch from the same key; the sketch
#   differs in low bits, which can move rows that sit on a cluster
#   boundary.  Per-window NMI between the GPU and CPU labels >= 0.9.  The
#   same limit holds the GPU's scanned group (one lax.scan program, fused
#   and rounded as XLA compiles it) against per-window dispatch.
LABEL_NMI_MIN = 0.90
#   A window may sit between two k-means optima of near-equal cost: on
#   flagship window 7 a 1e-3 relative perturbation of the reduced window
#   (TF32's rounding) moves KMeans, from the same key, to the other optimum
#   (NMI 0.857, cost 2e-4 lower).  A window whose labels fall below the NMI
#   limit must then be an equally good clustering: its k-means cost on the
#   reference's reduced window within 1% of the reference labels' cost.
KMEANS_COST_REL_MAX = 0.01
# * huge window: binned selection is exact top-k over the same candidate
#   bins on both devices, so a block's edges differ only by tie flips, as
#   above (EDGE_AGREEMENT_MIN).  The candidate fold's edge count may move
#   by one per flip (1e-3 of the count).  Its sketch folds the same edges
#   through candidate products with bf16 probe operands and TF32 on the
#   GPU: the two sketches differ (their singular values by 1.5e-2 of the
#   largest on the card), so each is held, like the windows' sketches, to
#   the FD bound and to within SKETCH_ERR_REL_MAX of the other's covariance
#   error, estimated on the card against the dense 16,384-row adjacency.
EDGE_COUNT_REL_MAX = 1e-3
# * multichip: the stream metrics at noise 0.95 with binary labels sit at
#   NMI ~0, so they are reported, not compared.  Where the 4-card path
#   computes the same quantity as one card in another summation order, the
#   quantity itself is compared: the reduced window's singular values
#   (distributed SVD, to 1% of the largest) and the huge window's integer
#   edge count and sketch energy (column-sharded fold, exact / 1%).  The
#   engine's merged FD sketch (all_gather or ring) is a different sketch
#   with the same guarantee, so window 0's is held to the FD bound against
#   the 1-card fused adjacency; its labels are reported, not compared.
SPECTRUM_REL_MAX = 0.01


def log(msg: str) -> None:
    print(msg, flush=True)


def require_gpu(count: int = 1):
    """JAX's first device when it is a GPU and ``count`` are visible."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (jax platform "
                         f"{devs[0].platform!r}); this smoke test runs on "
                         "the accelerator only")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found {len(devs)}")
    return devs[0]


def card_lines() -> list[str]:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def flagship_data(subset: int = SUBSET, seed: int = 0):
    """The reference-default stream: a 2*subset pool (main.load_dataframe's
    sizing) sampled down to ``subset`` rows at noise 0.95, binary labels."""
    from mused_tpu import api
    from mused_tpu.data.synthetic import synthetic_events_dataframe
    df = synthetic_events_dataframe(n_rows=2 * subset, n_events=6,
                                    noise_rate=0.5, seed=seed)
    return api.prepare_modalities(df, subset_size=subset, binary=True,
                                  sort_by_uploaded=False, noise_rate=NOISE,
                                  seed=seed)


def run_stream(mods, mtypes, labels, approach: str, window: int,
               reduced_dim: int = REDUCED_DIM, k_basis: int = K_BASIS,
               cfg=None) -> tuple[dict, float]:
    from mused_tpu import api
    results, _ = api.get_initial_results()
    t0 = time.perf_counter()
    results = api.process_streaming_data(
        results=results, data_modalities=mods, modality_types=mtypes,
        window_size=window, reduced_dim=reduced_dim, k_basis=k_basis,
        n_clusters_total=2, seed=0, approach=approach,
        complete_true_labels=labels, step_window_ratio=1, noise_rate=NOISE,
        label_mode="binary", sorting=False, eps=1.5, min_samples=2, cfg=cfg)
    wall = time.perf_counter() - t0
    f1, nmi = results["f1_score"][0], results["nmi_score"][0]
    if not (np.isfinite(f1) and np.isfinite(nmi) and 0 <= nmi <= 1):
        raise AssertionError(f"{approach}: metrics out of range {f1} {nmi}")
    return results, wall


def phase_flagship(data, window: int = WINDOW, **kw) -> None:
    mods, mtypes, labels = data
    n_windows = len(labels) // window
    for approach in ("SWFDMC", "sSVDMC"):
        _, first = run_stream(mods, mtypes, labels, approach, window, **kw)
        res, steady = run_stream(mods, mtypes, labels, approach, window, **kw)
        log(f"flagship {approach}: f1={res['f1_score'][0]:.4f} "
            f"nmi={res['nmi_score'][0]:.4f} windows={n_windows} "
            f"first_run_s={first:.2f} compile_s~{first - steady:.2f} "
            f"steady_windows_per_s={n_windows / steady:.2f}")


def phase_serving(data, window: int = WINDOW, n_windows: int = 10,
                  **kw) -> None:
    from mused_tpu.serving import StreamDetector
    mods, mtypes, _ = data
    total = window * n_windows
    chunks = (317, 1500, 4000, 29, 2222, 999)
    for attempt in ("first", "steady"):
        det = StreamDetector(mtypes, window, k_estimate="eigengap", **kw)
        out, lo, i = [], 0, 0
        t0 = time.perf_counter()
        while lo < total:
            hi = min(lo + chunks[i % len(chunks)], total)
            out.extend(det.push([m[lo:hi] for m in mods]))
            lo, i = hi, i + 1
        out.extend(det.flush())
        wall = time.perf_counter() - t0
        if len(out) != n_windows:
            raise AssertionError(f"serving emitted {len(out)} windows, "
                                 f"expected {n_windows}")
        for r in out:
            if r.clusters.shape != (window,):
                raise AssertionError(f"window {r.window_index}: clusters "
                                     f"shape {r.clusters.shape}")
        log(f"serving {attempt}: windows={len(out)} pushes={i} "
            f"wall_s={wall:.2f} windows_per_s={n_windows / wall:.2f}")


def phase_huge(data, window: int = HUGE_WINDOW, **kw) -> None:
    mods, mtypes, labels = data
    sl = [m[:window] for m in mods]
    for attempt in ("first", "steady"):
        res, wall = run_stream(sl, mtypes, labels[:window], "SWFDMC", window,
                               **kw)
        log(f"huge {attempt}: window={window} f1={res['f1_score'][0]:.4f} "
            f"nmi={res['nmi_score'][0]:.4f} wall_s={wall:.2f}")


@jax.jit
def _modality_graphs(loc, tim, uid, tags_ids, text_ids, text_cnt, tags_valid):
    """The five kNN graphs of the flagship fusion (engine
    _fuse_standard_sparse), kept apart so each can be compared."""
    from mused_tpu.ops import affinity
    from mused_tpu.utils.config import FeatureConfig
    fc = FeatureConfig()
    tags = affinity.counts_from_tokens(tags_ids, None, fc.tags_hash_dim)
    text = affinity.counts_from_tokens(text_ids, text_cnt, fc.text_hash_dim)
    uid = uid.astype(jnp.int32)
    return (affinity.location_adjacency(loc, K_BASIS) > 0,
            affinity.time_adjacency(tim, K_BASIS) > 0,
            affinity.username_adjacency(uid) > 0,
            affinity.tags_adjacency(tags, K_BASIS, tags_valid) > 0,
            affinity.text_adjacency(text, K_BASIS) > 0)


def _on(device, fn, *args):
    with jax.default_device(device):
        out = fn(*jax.device_put(args, device))
        return jax.tree.map(np.asarray, out)


def _fold(fused):
    from mused_tpu.ops import fd
    sk, _, _ = fd.fold_sketch(fused.astype(jnp.float32), ell=REDUCED_DIM,
                              mode=fd.resolve_fold_mode("subspace"))
    return sk


def _engine(approach: str = "SWFDMC", window: int | None = None, **kw):
    """The flagship's StreamingEngine (reference defaults, binary labels;
    ``window`` defaults to WINDOW)."""
    from mused_tpu.engine.streaming import StreamingEngine
    from mused_tpu.utils.config import PipelineConfig
    return StreamingEngine(PipelineConfig(
        window_size=window or WINDOW, reduced_dim=REDUCED_DIM,
        k_basis=K_BASIS, approach=approach, label_mode="binary",
        n_clusters_override=2, **kw))


def _share(a, b) -> float:
    """Share of identical edges: |a & b| / |a | b|."""
    return float(np.logical_and(a, b).sum()
                 / max(np.logical_or(a, b).sum(), 1))


def _cov_err(a: np.ndarray, sketch: np.ndarray) -> float:
    """FD covariance error ||A^T A - B^T B||_2 of sketch B (ell, n)."""
    a, b = a.astype(np.float64), np.asarray(sketch, np.float64)
    return float(np.abs(np.linalg.eigvalsh(a.T @ a - b.T @ b)).max())


def _kmeans_cost(x: np.ndarray, labels: np.ndarray) -> float:
    """Within-cluster sum of squares of ``labels`` on the rows of ``x``."""
    x = np.asarray(x, np.float64)
    return float(sum(((x[labels == c] - x[labels == c].mean(0)) ** 2).sum()
                     for c in np.unique(labels)))


def _labels_agree(ref, ref_reduced, other) -> tuple[float, float]:
    """(NMI, relative k-means cost excess of ``other`` over ``ref`` on the
    reference's reduced window) — see KMEANS_COST_REL_MAX."""
    from mused_tpu.utils.metrics import nmi
    base = _kmeans_cost(ref_reduced, ref)
    return (nmi(ref, other),
            (_kmeans_cost(ref_reduced, other) - base) / max(base, 1e-12))


def _window_labels(device, data, n_windows: int):
    """Raw per-window (labels, reduced window) of the flagship SWFDMC
    engine, one dispatch per window (W=1), on ``device``."""
    mods, mtypes, labels = data
    out = []
    with jax.default_device(device):
        eng = _engine(windows_per_batch=1)
        for w in range(n_windows):
            lo, hi = w * WINDOW, (w + 1) * WINDOW
            p = eng.dispatch_window([m[lo:hi] for m in mods], mtypes,
                                    labels[lo:hi], w, None)
            out.append((np.asarray(p.labels), np.asarray(p.reduced)))
    return out


def _scanned_labels(device, data, batch_w: int) -> list[np.ndarray]:
    """Raw labels of the first ``batch_w`` flagship windows as ONE scanned
    group — the dispatch the offline loop makes at that W
    (engine.streaming.scanned_group_dispatch), on ``device``."""
    from mused_tpu.engine import streaming as es
    mods, mtypes, labels = data
    with jax.default_device(device):
        eng = _engine(windows_per_batch=batch_w)
        spans = [(w * WINDOW, (w + 1) * WINDOW) for w in range(batch_w)]
        batch = jax.device_put(es.stack_window_features(
            [tuple(eng.featurize([m[lo:hi] for m in mods], mtypes))
             for lo, hi in spans]), device)
        n_clusters = jnp.asarray([len(np.unique(labels[lo:hi]))
                                  for lo, hi in spans], jnp.int32)
        keys = jax.vmap(lambda w: jax.random.fold_in(
            jax.random.key(eng.cfg.seed), w))(jnp.arange(batch_w))
        out, _ = es.scanned_group_dispatch(
            eng, batch, n_clusters, keys,
            types=es.scanned_types_for(mtypes, eng.cfg.features),
            k_source="given")
        return list(np.asarray(out))


def phase_compare(data, gpu, cpu, n_windows: int = COMPARE_WINDOWS) -> None:
    from mused_tpu.data import features as feat
    from mused_tpu.engine.streaming import resolve_windows_per_batch
    from mused_tpu.utils.config import FeatureConfig
    mods, mtypes, labels = data
    names = ("location", "time", "username", "tags", "text")
    worst = {m: 1.0 for m in names + ("fused",)}
    for w in range(n_windows):
        lo, hi = w * WINDOW, (w + 1) * WINDOW
        f = feat.featurize_window(*[m[lo:hi] for m in mods], FeatureConfig())
        g_gpu = _on(gpu, _modality_graphs, *(np.asarray(x) for x in f))
        g_cpu = _on(cpu, _modality_graphs, *(np.asarray(x) for x in f))
        for name, a, b in zip(names, g_gpu, g_cpu):
            worst[name] = min(worst[name], _share(a, b))
        # the engine's own fusion (one jitted program) on both devices, and
        # against the OR of the five graphs above on the card
        fused = {}
        for tag, dev in (("gpu", gpu), ("cpu", cpu)):
            with jax.default_device(dev):
                fused[tag] = np.asarray(_engine().fuse_from_features(
                    jax.device_put(f, dev), mtypes)) > 0
        worst["fused"] = min(worst["fused"],
                             _share(fused["gpu"], fused["cpu"]),
                             _share(fused["gpu"],
                                    np.logical_or.reduce(g_gpu)))
        a = fused["cpu"].astype(np.float32)
        bound = float(a.sum()) / REDUCED_DIM
        err = {tag: _cov_err(a, _on(dev, _fold, a))
               for tag, dev in (("gpu", gpu), ("cpu", cpu))}
        rel = abs(err["gpu"] - err["cpu"]) / max(err["cpu"], 1e-12)
        log(f"compare window {w}: sketch_cov_err gpu={err['gpu']:.2f} "
            f"cpu={err['cpu']:.2f} bound={bound:.2f} rel_diff={rel:.4f}")
        if max(err.values()) > bound or rel > SKETCH_ERR_REL_MAX:
            raise AssertionError(f"window {w}: sketch error {err} "
                                 f"(bound {bound:.2f})")
    log("compare edges (min share identical over windows): " + " ".join(
        f"{m}={v:.5f}" for m, v in worst.items()))
    bad = {m: v for m, v in worst.items() if v < EDGE_AGREEMENT_MIN}
    if bad:
        raise AssertionError(f"edge agreement below {EDGE_AGREEMENT_MIN}: "
                             f"{bad}")
    lab_gpu = _window_labels(gpu, data, n_windows)
    lab_cpu = _window_labels(cpu, data, n_windows)
    pairs = [_labels_agree(c, x, g)
             for (g, _), (c, x) in zip(lab_gpu, lab_cpu)]
    log("compare labels (nmi, kmeans cost excess) gpu vs cpu per window: "
        + " ".join(f"({v:.4f}, {c:+.1e})" for v, c in pairs))
    # the offline loop's W on the card for the flagship's 75 windows
    batch_w = resolve_windows_per_batch(
        _engine().cfg, standard_types=True,
        n_windows=len(labels) // WINDOW)
    scan = []
    if batch_w > 1:
        scan = [_labels_agree(g, x, s) for s, (g, x) in
                zip(_scanned_labels(gpu, data, batch_w), lab_gpu)]
        log(f"compare labels (nmi, kmeans cost excess) gpu scanned "
            f"W={batch_w} vs gpu W=1 per window: "
            + " ".join(f"({v:.4f}, {c:+.1e})" for v, c in scan))
    if any(v < LABEL_NMI_MIN and c > KMEANS_COST_REL_MAX
           for v, c in pairs + scan):
        raise AssertionError(f"labels disagree beyond NMI {LABEL_NMI_MIN} "
                             f"and k-means cost {KMEANS_COST_REL_MAX}: "
                             f"{pairs} {scan}")
    phase_compare_huge(data, gpu, cpu)


@functools.partial(jax.jit, static_argnames="iters")
def _fd_err(a, sketch, iters: int = 100):
    """FD covariance error ||A^T A - B^T B||_2 by power iteration from a
    fixed start (the matrix is PSD under the FD guarantee), for an ``a``
    too large for a host eigendecomposition."""
    hi = jax.lax.Precision.HIGHEST

    def mv(v):
        return (jnp.dot(a.T, jnp.dot(a, v, precision=hi), precision=hi)
                - jnp.dot(sketch.T, jnp.dot(sketch, v, precision=hi),
                          precision=hi))

    def step(v, _):
        w = mv(v)
        return w / jnp.linalg.norm(w), None

    v = jax.random.normal(jax.random.key(0), (a.shape[1],), a.dtype)
    v, _ = jax.lax.scan(step, v / jnp.linalg.norm(v), None, length=iters)
    return jnp.abs(jnp.dot(v, mv(v), precision=hi))


def _jit_cols(fn, cols):
    """``fn(Columns)`` jitted over the columns' arrays (kinds are static)."""
    from mused_tpu.ops import blocked_affinity as ba
    return jax.jit(lambda t, v, i: fn(ba.Columns(kinds=cols.kinds, tensors=t,
                                                 valids=v, idf=i)))


def phase_compare_huge(data, gpu, cpu) -> None:
    """Binned selection and the candidate fold — the card's huge-window
    defaults — forced on both devices: one full-width row block of the
    98,304-row window, and the fold of the first 16,384 rows."""
    from mused_tpu.data import features as feat
    from mused_tpu.ops import binned_select as bsel
    from mused_tpu.ops import blocked_affinity as ba
    from mused_tpu.utils.config import FeatureConfig
    mods, fc = data[0], FeatureConfig()
    cols = ba.standard_columns(feat.featurize_window(
        *[m[:HUGE_WINDOW] for m in mods], fc), fc)
    nbins = bsel.default_nbins(cols.n, k_max=3 * K_BASIS)
    start = cols.n // 2 // HUGE_BLOCK * HUGE_BLOCK
    blk = _jit_cols(lambda c: ba.fused_rowblock(
        c, start, HUGE_BLOCK, K_BASIS, approx=True, select="binned",
        nbins=nbins, out_dtype=jnp.bfloat16), cols)
    args = (cols.tensors, cols.valids, cols.idf)
    rows = {tag: _on(dev, blk, *args) > 0
            for tag, dev in (("gpu", gpu), ("cpu", cpu))}
    share = _share(rows["gpu"], rows["cpu"])
    log(f"compare huge block rows [{start}, {start + HUGE_BLOCK}) x "
        f"{cols.n} binned: edges gpu={int(rows['gpu'].sum())} "
        f"cpu={int(rows['cpu'].sum())} share_identical={share:.5f}")

    cols = ba.standard_columns(feat.featurize_window(
        *[m[:HUGE_FOLD_ROWS] for m in mods], fc), fc)
    nbins = bsel.default_nbins(cols.n, k_max=3 * K_BASIS)
    fold = _jit_cols(lambda c: ba.blocked_fd_sketch(
        c, ell=REDUCED_DIM, block=HUGE_BLOCK, k_basis=K_BASIS,
        approx_knn=True, select="binned", nbins=nbins, cand_fold=True)[:2],
        cols)
    out = {tag: _on(dev, fold, cols.tensors, cols.valids, cols.idf)
           for tag, dev in (("gpu", gpu), ("cpu", cpu))}
    dense = _jit_cols(lambda c: jnp.concatenate([ba.fused_rowblock(
        c, lo, HUGE_BLOCK, K_BASIS, approx=True, select="binned",
        nbins=nbins) for lo in range(0, c.n, HUGE_BLOCK)]), cols)
    with jax.default_device(gpu):
        a = dense(*jax.device_put((cols.tensors, cols.valids, cols.idf),
                                  gpu))
        err = {tag: float(_fd_err(a, jnp.asarray(sk)))
               for tag, (sk, _) in out.items()}
        bound = float(jnp.sum(a)) / REDUCED_DIM
    rel = abs(err["gpu"] - err["cpu"]) / max(err["cpu"], 1e-12)
    sq = {tag: float(q) for tag, (_, q) in out.items()}
    sq_rel = abs(sq["gpu"] - sq["cpu"]) / max(sq["cpu"], 1.0)
    log(f"compare huge fold {cols.n} rows binned + candidate fold: edges "
        f"gpu={sq['gpu']:.0f} cpu={sq['cpu']:.0f} rel_diff={sq_rel:.2e}; "
        f"sketch_cov_err gpu={err['gpu']:.2f} cpu={err['cpu']:.2f} "
        f"bound={bound:.2f} rel_diff={rel:.4f}")
    if (share < EDGE_AGREEMENT_MIN or sq_rel > EDGE_COUNT_REL_MAX
            or max(err.values()) > bound or rel > SKETCH_ERR_REL_MAX):
        raise AssertionError("huge window: GPU and CPU disagree beyond the "
                             "stated tolerances")


def phase_gpu_tests() -> None:
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests", "test_gpu.py")])
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest exit {rc})")
    log("gpu tests: passed")


def phase_multichip(data, window: int = WINDOW,
                    huge_window: int = HUGE_WINDOW, shards: int = 4) -> None:
    """4-card mesh paths against the same work on one card."""
    from mused_tpu.data import features as feat
    from mused_tpu.parallel import mesh as mesh_mod
    from mused_tpu.utils.config import FeatureConfig, PipelineConfig
    mods, mtypes, labels = data

    def cfg(approach, w, **kw):
        return PipelineConfig(window_size=w, reduced_dim=REDUCED_DIM,
                              k_basis=K_BASIS, approach=approach,
                              label_mode="binary", n_clusters_override=2,
                              **kw)

    def line(name, one, many, t1, tn):
        log(f"multichip {name}: f1 1card={one['f1_score'][0]:.4f} "
            f"{shards}card={many['f1_score'][0]:.4f} nmi "
            f"1card={one['nmi_score'][0]:.4f} "
            f"{shards}card={many['nmi_score'][0]:.4f} "
            f"1card_s={t1:.2f} {shards}card_s={tn:.2f}")

    def first_window(c):
        from mused_tpu.engine.streaming import StreamingEngine
        eng = StreamingEngine(c)
        p = eng.dispatch_window([m[:window] for m in mods], mtypes,
                                labels[:window], 0, None)
        return np.asarray(p.reduced, np.float64), np.asarray(p.labels)

    # window 0's fused adjacency from the 1-card engine: the matrix every
    # SWFDMC sketch below must approximate within the FD bound
    from mused_tpu.utils.metrics import nmi
    f = feat.featurize_window(*[m[:window] for m in mods], FeatureConfig())
    with jax.default_device(jax.devices()[0]):
        a = (np.asarray(_engine(window=window).fuse_from_features(
            f, mtypes)) > 0).astype(np.float32)
    bound = float(a.sum()) / REDUCED_DIM

    # row-sharded SPMD streams; second runs are the timed ones.  SWFDMC
    # runs both sketch merges through the engine (merge_topology)
    for approach in ("SWFDMC", "sSVDMC"):
        topos = ("allgather", "ring") if approach == "SWFDMC" else (
            "allgather",)
        runs = {}
        for p in (1, shards):
            c = cfg(approach, window, data_shards=p)
            run_stream(mods, mtypes, labels, approach, window, cfg=c)
            runs[p] = run_stream(mods, mtypes, labels, approach, window,
                                 cfg=c)
        line(f"{approach} data_shards={shards} stream", runs[1][0],
             runs[shards][0], runs[1][1], runs[shards][1])
        r1, l1 = first_window(cfg(approach, window))
        s1 = np.linalg.svd(r1, compute_uv=False)
        for topo in topos:
            c = cfg(approach, window, data_shards=shards,
                    merge_topology=topo)
            if topo != "allgather":     # one (compiling) run of the stream
                res, t = run_stream(mods, mtypes, labels, approach, window,
                                    cfg=c)
                log(f"multichip {approach} data_shards={shards} {topo} "
                    f"stream: f1={res['f1_score'][0]:.4f} "
                    f"nmi={res['nmi_score'][0]:.4f} first_run_s={t:.2f}")
            rp, lp = first_window(c)
            sp = np.linalg.svd(rp, compute_uv=False)
            rel = float(np.abs(s1 - sp).max() / s1[0])
            msg = (f"multichip {approach} {topo} window 0: reduced spectrum "
                   f"max diff / sigma_max={rel:.2e} labels nmi(1card, "
                   f"{shards}card)={nmi(l1, lp):.4f}")
            if approach == "SWFDMC":
                # reduced = the queried sketch's transpose (engine step)
                err1, errp = _cov_err(a, r1.T), _cov_err(a, rp.T)
                log(f"{msg} sketch_cov_err 1card={err1:.2f} "
                    f"{shards}card={errp:.2f} bound={bound:.2f}")
                if max(err1, errp) > bound:
                    raise AssertionError(f"SWFDMC {topo}: sketch error "
                                         f"{errp:.2f} above the FD bound")
                continue
            log(msg)
            # sSVDMC's distributed randomized SVD is the 1-card recipe
            # (same probe from the same key) with psum'd products: only
            # summation order and TF32 rounding differ, so every singular
            # value of the reduced window agrees to 1% of the largest; a
            # shard-layout error moves them at the scale of the largest
            if rel > SPECTRUM_REL_MAX:
                raise AssertionError(f"sSVDMC: {shards}-card reduced "
                                     f"spectrum differs from 1 card by "
                                     f"{rel:.2e}")
    mesh = mesh_mod.make_mesh(n_data=shards)

    # huge window, features column-sharded over the mesh, against the
    # 1-card blocked sweep with the same bins and blocks: the adjacency is
    # the same (so the integer edge count must be identical) and the fold
    # differs only in psum summation order (sketch energy within 1%)
    from mused_tpu.ops import binned_select as bsel
    from mused_tpu.ops import blocked_affinity as ba
    from mused_tpu.parallel import colsharded as cs
    fc = FeatureConfig()
    f = feat.featurize_window(*[m[:huge_window] for m in mods], fc)
    cols = ba.standard_columns(f, fc)
    nbins = bsel.default_nbins(cols.n, k_max=3 * K_BASIS)
    block = min(2048, huge_window // shards)
    out = {}
    for name, fn in (
            ("1card", lambda: ba.blocked_fd_sketch(
                cols, ell=REDUCED_DIM, block=block, k_basis=K_BASIS,
                select="binned", nbins=nbins)),
            ("columns", lambda: cs.colsharded_blocked_fd_sketch(
                tuple(f), ("standard_sparse",), ell=REDUCED_DIM, block=block,
                k_basis=K_BASIS, mesh=mesh, nbins=nbins))):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        sk, sq, _ = jax.block_until_ready(fn())
        out[name] = (float(jnp.sum(jnp.square(sk))), float(sq), first,
                     time.perf_counter() - t0)
    (e1, sq1, _, t1), (ep, sqp, fp, tp) = out["1card"], out["columns"]
    rel = abs(e1 - ep) / max(e1, 1e-12)
    log(f"multichip huge columns layout: edges 1card={sq1:.0f} "
        f"{shards}card={sqp:.0f} sketch_energy_rel_diff={rel:.5f} "
        f"1card_s={t1:.2f} {shards}card_first_s={fp:.2f} "
        f"{shards}card_s={tp:.2f}")
    if sq1 != sqp or rel > 0.01:
        raise AssertionError("columns layout: adjacency or sketch differs "
                             "from the 1-card sweep")
    many, tn = run_stream([m[:huge_window] for m in mods], mtypes,
                          labels[:huge_window], "SWFDMC", huge_window,
                          cfg=cfg("SWFDMC", huge_window, data_shards=shards,
                                  huge_window_layout="columns"))
    log(f"multichip huge columns engine window: f1={many['f1_score'][0]:.4f} "
        f"nmi={many['nmi_score'][0]:.4f} wall_s={tn:.2f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the 4-card mesh phase (needs 4 GPUs)")
    args = ap.parse_args(argv)
    count = 4 if args.multichip else 1
    gpu = require_gpu(count)
    sys.path.insert(0, HERE)
    from mused_tpu.utils.runtime import enable_compilation_cache
    cache = enable_compilation_cache()
    for line in card_lines():
        log(f"card: {line}")
    log(f"jax {jax.__version__}; devices {len(jax.devices())}x "
        f"{gpu.device_kind}; compile cache {cache}")

    t0 = time.perf_counter()
    data = flagship_data()
    log(f"data: {len(data[2])} rows in {time.perf_counter() - t0:.2f}s")
    if args.multichip:
        phase_multichip(data)
    else:
        phases = (("flagship", lambda: phase_flagship(data)),
                  ("serving", lambda: phase_serving(data)),
                  ("huge", lambda: phase_huge(data)),
                  ("compare", lambda: phase_compare(
                      data, gpu, jax.devices("cpu")[0])),
                  ("gpu tests", phase_gpu_tests))
        for name, fn in phases:
            t = time.perf_counter()
            fn()
            log(f"phase {name}: ok in {time.perf_counter() - t:.1f}s")
    log(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": gpu.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
