"""Online serving API: push records as they arrive, get events out.

The reference has no serving surface — its only entry point
(``process_streaming_data``, reference main.py:13-130) needs the WHOLE stream
and its ground-truth labels up front: the label array sizes each window's
cluster count (main.py:41) and the engine returns only end-of-stream metrics.
``StreamDetector`` wraps the same device engine for production use:

  * records are **pushed incrementally** (single records or chunks) — no
    subset array, no ground truth anywhere;
  * windows fire on the reference trigger semantics (main.py:32), including
    overlapping sliding windows via ``step_window_ratio``;
  * the per-window cluster count comes from the device eigengap estimate
    (``k_estimate="eigengap"``, ops/reduction.eigengap_k) or a fixed cap —
    never from labels;
  * cluster IDs stay stable across windows through the engine's matching
    (Hungarian positional overlap, or the centroid registry for numeric
    streams), surfaced as per-window :class:`WindowResult` events;
  * the device pipeline stays asynchronous: featurize + dispatch run on a
    background worker thread (``dispatch_ahead`` queued groups, bounded —
    at saturation pushes backpressure instead of buffering unboundedly),
    and up to ``max_lag`` windows stay un-pulled ahead of the oldest
    finalized one, so pushes return without blocking on device compute
    (``flush()`` drains; results may additionally lag by the in-flight
    work, at most ``dispatch_ahead + 1`` groups — the queued ones plus
    the group the worker is processing);
  * eligible configs batch W ready windows into ONE scanned device dispatch
    (``windows_per_batch``, same lax.scan as the offline engine — auto W
    per platform, utils.runtime.platform_paths; numerically identical to
    per-window); batching buffers up
    to W-1 additional windows before dispatch, so results may lag up to
    ``W - 1 + max_lag`` windows behind pushes (``flush()`` still drains
    exactly — a partial group dispatches per-window, never padded, so the
    sketch state sees each window exactly once);
  * ``background=True`` adds the label-free background bucket
    (ops/kmeans.mark_background): rows in the far mode of the embedding
    distance-to-centroid distribution get event id -1 ("no event") instead
    of being forced into a cluster — matching passes -1 through, so the
    background id is globally stable (crisis stream at noise 0.3: serving
    NMI 0.69 -> 0.87 with events-only NMI intact);
  * ``save()``/``load()`` checkpoint the full detector (device sketch state,
    matcher registries, the raw-record tail needed for the next windows) for
    crash recovery or migration between hosts.

Everything downstream of featurization is the same jitted/SPMD window step
the offline engine runs — serving adds no second compute path.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import queue
import threading
from typing import NamedTuple, Sequence

import numpy as np

from mused_tpu.engine import streaming as engine_mod
from mused_tpu.utils.config import FeatureConfig, PipelineConfig


class _DispatchWorker:
    """Single background thread owning featurize + device dispatch.

    Same pattern as the ingest WindowPrefetcher (data/ingest.py): the host
    hashing + dispatch cost leaves the caller thread, so ``push()`` is a
    copy + enqueue (~ms) instead of a full window dispatch (the round-4
    175 ms p99, bench_detail 6_serving_push_p99_ms).  One thread, FIFO —
    the engine's device state is strictly sequential across windows.  The
    queue is BOUNDED: at saturation pushes block on a free slot
    (backpressure) rather than buffering the stream unboundedly.
    """

    def __init__(self, depth: int):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._exc: BaseException | None = None
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="serving-dispatch")
        self._t.start()

    def submit(self, fn) -> None:
        self.check()
        self._q.put(fn)

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            try:
                if fn is None:
                    return
                if self._exc is None:   # after a failure: drain, don't run
                    fn()
            except BaseException as e:  # noqa: BLE001 — re-raised at caller
                self._exc = e
            finally:
                self._q.task_done()

    def drain(self) -> None:
        """Block until every submitted dispatch has completed."""
        self._q.join()
        self.check()

    def check(self) -> None:
        # a dispatch failure POISONS the detector permanently: windows
        # after the failed one were skipped (never folded into the sketch
        # state), so the stream is broken — every subsequent push/flush/
        # save must keep failing rather than silently emit a stream with
        # windows missing (review r5 finding #2)
        if self._exc is not None:
            raise RuntimeError(
                "serving dispatch worker failed; this detector's stream "
                "state is broken past the failed window — restore from the "
                "last save()") from self._exc

    def stop(self) -> None:
        try:
            self._q.put_nowait(None)
        except queue.Full:      # daemon thread; wedged queue must not
            pass                # block GC/interpreter shutdown (__del__)


def _entry_ready(entry) -> bool:
    """True when finalizing ``entry`` will not block on device compute.

    ``Array.is_ready()`` reports False right after dispatch and True once
    the computation completes (the pull itself then costs only the
    transfer — labels are KBs).  Any probe failure degrades to True, i.e.
    a blocking finalize."""
    try:
        if len(entry) == 2:                      # per-window _PendingWindow
            p = entry[1]
            if p.clusters is not None:           # huge-window: already done
                return True
            arr = p.labels if p.labels is not None else p.reduced
            return arr is None or arr.is_ready()
        handle = entry[3]                        # scanned group member
        return handle._host is not None or handle._device_labels.is_ready()
    except Exception:                            # noqa: BLE001
        return True


class _GroupHandle:
    """Lazily-pulled scanned-group results (one device->host transfer per
    group, shared by its W pending windows)."""

    def __init__(self, batch_labels, r_norms):
        self._device_labels = batch_labels
        self.r_norms = r_norms
        self._host = None

    def pull(self) -> np.ndarray:
        if self._host is None:
            self._host = np.asarray(self._device_labels)
            self._device_labels = None
        return self._host


class WindowResult(NamedTuple):
    """One processed window's events."""

    window_index: int
    row_start: int          # absolute stream index of the window's first row
    clusters: np.ndarray    # (window_size,) stable event id per record;
                            # -1 = background ("no event", background_bucket)
    event_ids: np.ndarray   # unique event ids present in this window (no -1)
    counts: np.ndarray      # record count per event_ids entry
    new_events: np.ndarray  # event ids first seen in this window (no -1)
    background: int = 0     # rows in this window's background bucket


class StreamDetector:
    """Push-based online event detector (production serving surface).

    Parameters mirror :class:`PipelineConfig`; pass ``cfg`` directly for full
    control.  ``k_estimate`` must be label-free ("eigengap" or "fixed") —
    serving has no ground truth, so the reference's labels-derived count
    (main.py:41) is rejected.
    """

    def __init__(self, modality_types: Sequence[str], window_size: int, *,
                 approach: str = "SWFDMC", reduced_dim: int = 50,
                 k_basis: int = 50, max_events: int = 150,
                 k_estimate: str = "eigengap", step_window_ratio: int = 1,
                 seed: int = 0, matching: str = "auto", max_lag: int = 2,
                 dispatch_ahead: int = 2, background: bool = False,
                 cfg: PipelineConfig | None = None):
        if cfg is None:
            cfg = PipelineConfig(
                window_size=window_size, reduced_dim=reduced_dim,
                k_basis=k_basis, approach=approach, seed=seed,
                label_mode="all", n_clusters_override=max_events,
                matching=matching, k_estimate=k_estimate,
                step_window_ratio=step_window_ratio,
                background_bucket=background)
        if cfg.k_estimate == "labels":
            raise ValueError(
                "serving is unsupervised: k_estimate must be 'eigengap' or "
                "'fixed' ('labels' is the offline reference quirk that "
                "derives each window's cluster count from ground truth)")
        self.cfg = cfg
        self.modality_types = tuple(modality_types)
        self.engine = engine_mod.StreamingEngine(cfg)
        self.max_lag = max(int(max_lag), 0)
        if (cfg.window_size > engine_mod.LARGE_WINDOW_ROWS
                or cfg.force_blocked_window):
            # the huge-window path matches inside dispatch (it runs its own
            # blocked sub-stream to completion), so it needs the previous
            # window's MATCHED labels at dispatch time — no lag allowed
            self.max_lag = 0
        # retention: per-modality lists of immutable pushed chunks
        # covering at least the last window_size rows (see push())
        self._rchunks: list[list[np.ndarray]] = [
            [] for _ in self.modality_types]
        self._ret_start = 0      # absolute index of the first retained row
        self._ret_len = 0
        self._count = 0          # absolute records pushed
        self._window_index = 0
        self._prev_clusters: np.ndarray | None = None
        # [(row_start, _PendingWindow)  — per-window dispatch, or
        #  (row_start, widx, stable_feats, _GroupHandle, pos) — scanned]
        # appended by the dispatch worker, consumed by the caller thread
        # (single producer / single consumer; deque ops are GIL-atomic)
        self._pending: collections.deque[tuple] = collections.deque()
        self._seen_events: set[int] = set()
        # labels are never consulted (k_estimate is label-free); this array
        # only satisfies the engine's window-step signature
        self._dummy_labels = np.zeros(cfg.window_size, np.int64)
        # scanned multi-window dispatch (VERDICT r2 next #5): same
        # eligibility/auto rule as the offline engine; the huge-window
        # max_lag=0 clamp above also forces per-window
        standard = list(self.modality_types) == ["location", "time",
                                                 "username", "tags", "text"]
        self._batch_w = engine_mod.resolve_windows_per_batch(
            cfg, standard_types=standard,
            step_window_ratio=cfg.step_window_ratio)
        if self.max_lag == 0:
            self._batch_w = 1
        self._scan_types = engine_mod.scanned_types_for(self.modality_types,
                                                        cfg.features)
        self._gbuf: list[tuple[int, int, list[np.ndarray]]] = []
        # [(row_start, window_index, window rows)] awaiting a full group
        # async dispatch (round-5): featurize+dispatch leave the caller
        # thread whenever results may lag anyway (max_lag > 0; the
        # huge-window clamp above already forces max_lag=0, and its
        # dispatch needs prev labels, so it stays synchronous).  Lazily
        # created on first fire; depth 0 opts out entirely.
        self._dispatch_ahead = (int(dispatch_ahead)
                                if self.max_lag > 0 else 0)
        self._worker: _DispatchWorker | None = None

    # ------------------------------------------------------------------
    def push(self, modality_rows: Sequence[np.ndarray]) -> list[WindowResult]:
        """Feed one record or a chunk of records (one array per modality,
        each ``(n_new, width)`` — or ``(width,)`` for a single record).
        Returns any windows finalized by this push.  Results may lag up
        to ``max_lag`` windows of device pipelining PLUS the async
        dispatch in flight — at most ``W - 1`` group-buffered windows and
        ``(dispatch_ahead + 1) * W`` on the worker (17 windows at the
        defaults); ``flush()`` drains everything."""
        rows = [np.asarray(m) for m in modality_rows]
        if len(rows) != len(self.modality_types):
            raise ValueError(
                f"got {len(rows)} modality arrays, expected "
                f"{len(self.modality_types)} ({self.modality_types})")
        # contract: chunks are (n, width) — a bare 1-D array means ONE
        # record of that width.  Scalar (width-1) modalities must therefore
        # ship as (n, 1): a (n,) array is ambiguous with one n-wide record.
        if any(m.ndim == 0 for m in rows):
            raise ValueError(
                "modality arrays must be (n, width) chunks or (width,) "
                "single records; got a 0-d scalar — wrap scalar modalities "
                "as (n, 1)")
        rows = [m[None] if m.ndim == 1 else m for m in rows]
        n_new = len(rows[0])
        if any(len(m) != n_new for m in rows):
            raise ValueError(
                "modality chunks disagree on record count "
                f"({[len(m) for m in rows]}); scalar modalities must be "
                "shaped (n, 1) — a 1-D array is read as ONE record")

        w = self.cfg.window_size
        # retention is a per-modality CHUNK LIST (no per-push rebuild of a
        # window-sized buffer — a huge-window detector fed small chunks
        # would otherwise copy the whole window every push).  The one copy
        # here detaches the rows from the caller's arrays: retained chunks
        # are immutable, so window views handed to the async worker can
        # never see a caller reusing its buffer.
        rows = [np.array(m) for m in rows]
        for lst, m in zip(self._rchunks, rows):
            lst.append(m)
        self._ret_len += n_new
        end = self._count + n_new

        out: list[WindowResult] = []
        # reference trigger semantics (main.py:32): fire at record i when
        # i+1 >= w and ((i+1)*ratio) % w == 0  <=>  i+1 is a multiple of
        # w // gcd(ratio, w) that has reached one full window
        p = w // math.gcd(self.cfg.step_window_ratio, w)
        t0 = -(-max(w, self._count + 1) // p) * p
        for t in range(t0, end + 1, p):
            out.extend(self._fire(t - 1, self._window_rows(t - w, t)))
        self._count = end
        # drop whole chunks that can no longer intersect a future window
        # (every future window starts at >= count - w + 1)
        while (self._rchunks[0]
               and self._ret_len - len(self._rchunks[0][0]) >= w):
            n0 = len(self._rchunks[0][0])
            for lst in self._rchunks:
                lst.pop(0)
            self._ret_len -= n0
            self._ret_start += n0
        return out

    def _window_rows(self, lo: int, hi: int) -> list[np.ndarray]:
        """Rows [lo, hi) per modality from the retained chunk lists —
        a view when one chunk covers the range, else one concatenate.
        Retained chunks are immutable, so views are safe across the
        async dispatch boundary."""
        out = []
        for lst in self._rchunks:
            parts = []
            pos = self._ret_start
            for c in lst:
                s, e = max(lo - pos, 0), min(hi - pos, len(c))
                if e > s:
                    parts.append(c[s:e])
                pos += len(c)
                if pos >= hi:
                    break
            out.append(parts[0] if len(parts) == 1
                       else np.concatenate(parts))
        return out

    def _submit(self, fn) -> None:
        """Run ``fn`` on the dispatch worker (creating it lazily), or inline
        when async dispatch is disabled."""
        if self._dispatch_ahead <= 0:
            fn()
            return
        if self._worker is None:
            self._worker = _DispatchWorker(self._dispatch_ahead)
        self._worker.submit(fn)

    def _fire(self, i: int, window: list[np.ndarray]) -> list[WindowResult]:
        """Queue/dispatch the window ending at absolute index ``i``;
        finalize any windows beyond the ``max_lag`` pipeline depth."""
        row_start = i + 1 - self.cfg.window_size
        # window arrays are views/concats of the immutable retained
        # chunks — safe to hold across the async dispatch without copying
        if self._batch_w > 1:
            self._gbuf.append((row_start, self._window_index, window))
            self._window_index += 1
            if len(self._gbuf) == self._batch_w:
                group, self._gbuf = self._gbuf, []
                self._submit(lambda: self._dispatch_group(group))
        else:
            widx = self._window_index
            self._window_index += 1
            self._submit(
                lambda: self._dispatch_one(row_start, widx, window))
        return self._drain_ready()

    def _drain_ready(self) -> list[WindowResult]:
        """Finalize completed windows without blocking the push path.

        Below ``max_lag`` pending windows nothing finalizes (the device
        pipeline depth).  Between ``max_lag`` and the hard bound (max_lag
        plus everything the bounded worker can have in flight) windows
        finalize only when their device labels report ready — a push that
        lands right after a group dispatch no longer stalls on that
        group's compute (measured: the paced-load p99 was exactly one
        group's compute time).  Past the hard bound the pull blocks: the
        lag contract and host memory stay bounded."""
        hard = self.max_lag
        if self._worker is not None:
            hard += self._batch_w * (self._dispatch_ahead + 1)
        out = []
        while len(self._pending) > self.max_lag:
            if len(self._pending) <= hard and not _entry_ready(
                    self._pending[0]):
                break
            out.append(self._finalize_oldest())
        return out

    def _dispatch_one(self, row_start: int, widx: int,
                      rows: list[np.ndarray]) -> None:
        """Per-window dispatch (worker thread when async).  Non-huge
        dispatch never reads previous labels (matching is finalize-side),
        so it needs nothing from the caller thread."""
        pending = self.engine.dispatch_window(
            rows, self.modality_types, self._dummy_labels, widx,
            self._prev_clusters)
        self._pending.append((row_start, pending))

    def _dispatch_group(self, group) -> None:
        """One scanned device dispatch for a FULL group — the same lax.scan
        the offline engine's batched loop runs (numerically identical to
        per-window dispatch; state threads through the carry).  Runs on the
        dispatch worker when async.
        """
        import jax
        import jax.numpy as jnp
        from mused_tpu.engine.streaming import stack_window_features
        eng, cfg = self.engine, self.cfg
        feats_list, stable = [], []
        for _, _, rows in group:
            feats = eng.featurize(rows, self.modality_types)
            feats_list.append(tuple(feats))
            stable.append(eng._stable_feats(rows, feats))
        feats_batch = tuple(jnp.asarray(a) for a in
                            stack_window_features(feats_list))
        k_host, k_source = eng._k_plan(self._dummy_labels)
        n_clusters = jnp.full((len(group),), k_host, jnp.int32)
        keys = jax.vmap(lambda w: jax.random.fold_in(
            jax.random.key(cfg.seed), w))(
                jnp.asarray([w for _, w, _ in group]))
        # the shared helper is the single spelling of the scanned call —
        # serving and the offline loop can no longer drift (review r5 #4)
        batch_labels, r_norms = engine_mod.scanned_group_dispatch(
            eng, feats_batch, n_clusters, keys, types=self._scan_types,
            k_source=k_source)
        handle = _GroupHandle(batch_labels, r_norms)
        for pos, ((row_start, widx, _), sf) in enumerate(zip(group, stable)):
            self._pending.append((row_start, widx, sf, handle, pos))

    def _finalize_oldest(self) -> WindowResult:
        entry = self._pending.popleft()
        eng, cfg = self.engine, self.cfg
        if len(entry) == 2:              # per-window dispatch
            row_start, pending = entry
            widx = pending.window_index
            clusters = eng.finalize_window(pending, self._prev_clusters)
        else:                            # scanned group member
            row_start, widx, stable_feats, handle, pos = entry
            labels = handle.pull()[pos]
            if cfg.approach == "SWFDMC" and eng.swfd_R is None:
                eng.swfd_R = float(np.asarray(handle.r_norms)[0])
            clusters = engine_mod.match_window_labels(
                self._prev_clusters, labels, cfg,
                method=eng._match_method(),
                centroid_matcher=eng.centroid_matcher,
                stable_feats=stable_feats)
        self._prev_clusters = clusters
        ids, counts = np.unique(clusters, return_counts=True)
        # the background bucket id (-1) is "no event": it never appears in
        # event_ids/new_events (a phantom permanent event otherwise) —
        # background rows are visible in `clusters` and `background`
        n_background = 0
        if len(ids) and ids[0] == -1:
            n_background = int(counts[0])
            ids, counts = ids[1:], counts[1:]
        new = np.array([e for e in ids.tolist()
                        if e not in self._seen_events], ids.dtype)
        self._seen_events.update(ids.tolist())
        return WindowResult(window_index=widx,
                            row_start=row_start, clusters=clusters,
                            event_ids=ids, counts=counts, new_events=new,
                            background=n_background)

    def flush(self) -> list[WindowResult]:
        """Finalize every queued window.  In-flight async dispatches drain
        first; then a buffered partial group dispatches per-window (never
        padded — the sketch state must see each window exactly once,
        mid-stream), and everything finalizes."""
        if self._worker is not None:
            self._worker.drain()
        for row_start, widx, rows in self._gbuf:
            self._dispatch_one(row_start, widx, rows)
        self._gbuf = []
        out = []
        while self._pending:
            out.append(self._finalize_oldest())
        return out

    def __del__(self):
        worker = getattr(self, "_worker", None)
        if worker is not None:
            worker.stop()

    # ------------------------------------------------------------------
    def save(self, path: str) -> list[WindowResult]:
        """Checkpoint the detector (device state + matcher registries + the
        raw-record tail).  Pending windows are flushed first so the saved
        state is window-consistent — their results are returned.  Same trust
        model as utils/checkpoint.py: load only checkpoints you wrote."""
        flushed = self.flush()
        from mused_tpu.utils import checkpoint as ckpt
        ckpt.save_checkpoint(path, self.engine.state, {
            "serving": True,
            "count": self._count,
            "window_index": self._window_index,
            "prev_clusters": self._prev_clusters,
            "seen_events": sorted(self._seen_events),
            "tail": self._window_rows(max(0, self._count -
                                          self.cfg.window_size),
                                      self._count),
            "dispatch_ahead": self._dispatch_ahead,
            "modality_types": list(self.modality_types),
            # the FULL config (nested FeatureConfig included) — a partial
            # field list would silently rebuild different featurization/
            # clustering knobs on load and diverge from the pre-save windows
            "cfg_kwargs": dataclasses.asdict(self.cfg),
            **self.engine.host_snapshot()})
        return flushed

    @classmethod
    def load(cls, path: str, *, max_lag: int = 2,
             dispatch_ahead: int | None = None,
             cfg: PipelineConfig | None = None) -> "StreamDetector":
        """Rebuild a detector from :meth:`save` output; pushing resumes the
        stream exactly where it left off (the saved tail provides the
        overlap for the next windows).  ``dispatch_ahead=None`` restores
        the saved detector's async-dispatch depth (a deployment that ran
        synchronous dispatch stays synchronous after a restore)."""
        from mused_tpu.utils import checkpoint as ckpt
        device_state, host = ckpt.load_checkpoint(path)
        if not host.get("serving"):
            raise ValueError(f"{path} is not a StreamDetector checkpoint")
        if cfg is None:
            kw = dict(host["cfg_kwargs"])
            kw.pop("use_pallas_affinity", None)   # retired field, older saves
            if isinstance(kw.get("features"), dict):
                kw["features"] = FeatureConfig(**kw["features"])
            cfg = PipelineConfig(**kw)
        if dispatch_ahead is None:
            dispatch_ahead = int(host.get("dispatch_ahead", 2))
        det = cls(host["modality_types"], cfg.window_size, cfg=cfg,
                  max_lag=max_lag, dispatch_ahead=dispatch_ahead)
        det.engine.restore(device_state, host)
        det._count = int(host["count"])
        det._window_index = int(host["window_index"])
        det._prev_clusters = host["prev_clusters"]
        det._seen_events = set(host["seen_events"])
        tail = host["tail"]
        if tail is not None and len(tail) and len(tail[0]):
            det._rchunks = [[np.asarray(t)] for t in tail]
            det._ret_len = len(tail[0])
            det._ret_start = det._count - det._ret_len
        return det
