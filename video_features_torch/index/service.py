"""The serve-side face of the feature index (the port's copy of
``video_features_tpu/index/service.py``: the same records, cursor,
events, metrics, spans and errors).

One :class:`IndexService` rides inside one ``ExtractionServer``:

  * an **ingest worker** (daemon thread, its own watchdog row) tails
    the content-addressed cache's manifest by byte offset and folds
    every published framewise feature object into the
    :class:`~video_features_torch.index.shards.IndexStore` — normalized
    vectors plus (video, content hash, t_ms, cache key) identity. The
    cursor persists in the index manifest, so a restart resumes; a
    cache-manifest compaction (file shrank) resets it to zero and the
    store's key-dedupe makes the replay idempotent;
  * **delete-on-evict coherence**: the service subscribes to the
    cache's ``on_evict`` seam, so a row whose backing object was
    LRU-evicted (or corrupt-evicted) is tombstoned before the next
    query can return it;
  * the **query surface** behind the loopback ``search`` /
    ``index_status`` commands and ``POST /v1/search``: query-by-vector
    runs the exact top-k (:mod:`.search`) on the server's device;
    query-by-video extracts
    through the server's own (fused) submit path, waits for ingest to
    fold the result in, then queries with the video's own window
    embeddings.

Telemetry follows the house pattern: ``vft_index_*`` instruments on
the server's registry, an ``index`` section in the metrics document
(mirrored to gauges), ``index_ingest`` / ``index_query`` spans in the
merged trace, and an ``index`` section in the run manifest.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from video_features_torch.index.search import QueryEngine
from video_features_torch.index.shards import IndexStore
from video_features_torch.obs.events import event
from video_features_torch.utils.output import CorruptOutputError, load_numpy

# the ingest cursor's source id in the index manifest
CURSOR_SOURCE = 'cache_manifest'
# watchdog ledger row for the ingest worker
INGEST_WORKER = 'index-ingest'

# how long search_by_video waits for extraction + ingest to converge
# before answering with whatever is indexed (callers can override)
DEFAULT_SEARCH_TIMEOUT_S = 120.0


def fold_put(store: IndexStore, cache, key: str,
             rec: Dict[str, Any]) -> 'tuple[int, int]':
    """Fold one published cache entry into the index; returns
    ``(rows_added, objects_skipped)``. Entries without the framewise
    object pair (``<family>.npy`` + ``timestamps_ms.npy``) — packed
    multi-stream families, foreign writers — are skipped, not errors.
    Shared by the serve-side ingest worker and the offline ``index``
    CLI so both fold the SAME record semantics."""
    if store.has_key(key):
        return 0, 0
    meta = rec.get('meta') or {}
    family = meta.get('feature_type')
    files = rec.get('files') or {}
    feat = files.get(family) or {}
    ts = files.get('timestamps_ms') or {}
    if not family or not feat.get('name') or not ts.get('name'):
        return 0, 1
    edir = cache._entry_dir(key)        # same internal seam as gc tools
    try:
        vectors = load_numpy(os.path.join(edir, feat['name']))
        t_ms = load_numpy(os.path.join(edir, ts['name']))
    except (OSError, CorruptOutputError, ValueError):
        # evicted/corrupt between manifest append and this read: the
        # del record (or on_evict) owns the cleanup
        return 0, 1
    vectors = np.asarray(vectors)
    t_ms = np.asarray(t_ms).reshape(-1)
    if vectors.ndim != 2 or vectors.shape[0] != t_ms.shape[0] \
            or not vectors.shape[0]:
        return 0, 1
    metas = [{'video': meta.get('video'),
              'video_sha256': meta.get('video_sha256'),
              't_ms': int(t), 'key': key} for t in t_ms]
    return store.add_rows(family, vectors, metas), 0


def fold_manifest(store: IndexStore, cache) -> Dict[str, int]:
    """One offline ingest pass: fold every COMPLETE cache-manifest
    record past the persisted cursor and advance it — the
    ``python -m video_features_torch index --ingest`` path. Same cursor /
    replay semantics as the serve-side worker (a shrunken source means
    the cache compacted: replay from zero, key-dedupe keeps it
    idempotent)."""
    report = {'rows_added': 0, 'rows_dropped': 0, 'objects_skipped': 0,
              'bytes_folded': 0}
    try:
        size = os.path.getsize(cache.manifest_path)
    except OSError:
        size = 0
    cur = store.cursor(CURSOR_SOURCE)
    if size < cur:
        cur = 0
    if size <= cur:
        return report
    with open(cache.manifest_path, 'rb') as f:
        f.seek(cur)
        data = f.read(size - cur)
    last_nl = data.rfind(b'\n')
    if last_nl < 0:
        return report
    chunk = data[:last_nl + 1]
    for line in chunk.split(b'\n'):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except (ValueError, UnicodeDecodeError):
            continue                     # foreign/torn line: skip
        op, key = rec.get('op'), rec.get('key')
        if not key:
            continue
        if op == 'put':
            added, skipped = fold_put(store, cache, key, rec)
            report['rows_added'] += added
            report['objects_skipped'] += skipped
        elif op == 'del':
            report['rows_dropped'] += store.drop_key(key)
    store.set_cursor(CURSOR_SOURCE, cur + len(chunk))
    report['bytes_folded'] = len(chunk)
    return report


def resolve_index_dir(overrides: Dict[str, Any]) -> str:
    """``index_dir`` knob, else ``<cache_dir>/index`` — beside the
    objects the rows point into (NOT under ``objects/``, so cache GC's
    orphan sweep never touches it)."""
    index_dir = overrides.get('index_dir')
    if not index_dir:
        index_dir = os.path.join(str(overrides.get('cache_dir')), 'index')
    return os.path.abspath(os.path.expanduser(str(index_dir)))


class IndexService:
    """Ingest worker + query engine + stats for one serve process."""

    def __init__(self, server, overrides: Dict[str, Any]) -> None:
        self.server = server
        self.overrides = overrides
        self.poll_s = float(overrides.get('index_poll_s', 0.5))
        self.store = IndexStore.get(
            resolve_index_dir(overrides),
            shard_rows=int(overrides.get('index_shard_rows', 1024)))
        from video_features_torch.cache.store import FeatureCache
        cache_l2 = overrides.get('cache_l2_dir')
        if cache_l2:
            # fleet tier: ingest tails the LOCAL manifest as before, but
            # fetches of rows a peer published resolve through the L2
            from video_features_torch.fleet.tier import TieredFeatureCache
            self.cache = TieredFeatureCache.get_pair(
                overrides.get('cache_dir'), cache_l2,
                overrides.get('cache_max_bytes'))
        else:
            self.cache = FeatureCache.get(overrides.get('cache_dir'),
                                          overrides.get('cache_max_bytes'))
        # the queries reach no kernel library, so the executable store has
        # nothing to give them; they run on the server's device, as its
        # extractors do
        self.engine = QueryEngine(
            self.store, device=overrides.get('device', 'cuda'),
            query_block=int(overrides.get('index_query_block', 8)),
            k_max=int(overrides.get('index_k_max', 10)))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.ingest_lag_bytes = 0
        self.objects_skipped = 0
        self.ingest_errors = 0
        reg = server.registry
        self._c_rows = reg.counter(
            'vft_index_rows_indexed_total',
            'embedding rows folded into the feature index')
        self._c_dropped = reg.counter(
            'vft_index_rows_dropped_total',
            'index rows tombstoned (cache eviction / del replay)')
        self._c_queries = reg.counter(
            'vft_index_queries_total', 'index query vectors served')
        self._h_query = reg.histogram(
            'vft_index_query_latency_seconds',
            'index search latency (admission to merged hits)')
        self._g_lag = reg.gauge(
            'vft_index_ingest_lag_bytes',
            'cache-manifest bytes the ingest worker has not folded yet')
        self._recorder = None
        if server.base_overrides.get('trace_out'):
            # index spans join the server-wide merged Perfetto export —
            # persistent, like the ingress recorder: pool churn must not
            # age out the ingest worker's lane
            from video_features_torch.obs.spans import SpanRecorder
            self._recorder = SpanRecorder()
            server._persistent_recorders.append(self._recorder)
        # delete-on-evict coherence: fires AFTER the cache lock is
        # released (store queues notices, drains outside the lock), so
        # the callback may safely re-enter the cache — but it still
        # stays cheap (tombstone + one manifest line)
        self.cache.on_evict.append(self._on_cache_evict)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> 'IndexService':
        self._thread = threading.Thread(
            target=self._ingest_loop, name=INGEST_WORKER, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout_s)
        wd = getattr(self.server, 'watchdog', None)
        if wd is not None:
            wd.forget(INGEST_WORKER)
        try:
            self.cache.on_evict.remove(self._on_cache_evict)
        except ValueError:
            pass

    def prewarm(self) -> str:
        """Run the canonical top-k once before the first query (the
        ``serve_prewarm: [index]`` path); ``'jit'``, as the JAX package
        answers without an executable store."""
        path = self.engine.prewarm()
        event(logging.INFO, f'index query program {path}',
              subsystem='index', program='topk', path=path)
        return path

    # -- eviction coherence --------------------------------------------------

    def _on_cache_evict(self, key: str, corrupt: bool) -> None:
        dropped = self.store.drop_key(key)
        if dropped:
            self._c_dropped.inc(dropped)

    # -- ingest --------------------------------------------------------------

    def _ingest_loop(self) -> None:
        wd = getattr(self.server, 'watchdog', None)
        if wd is not None:
            wd.advance(INGEST_WORKER, 'index_ingest')
        while not self._stop.is_set():
            try:
                progressed = self._ingest_once()
            except Exception:
                with self._lock:
                    self.ingest_errors += 1
                event(logging.WARNING, 'index ingest cycle failed',
                      subsystem='index', exc_info=True)
                progressed = False
            self._stop.wait(0.01 if progressed else self.poll_s)

    def _ingest_once(self) -> bool:
        """Fold one batch of cache-manifest records; True if any byte
        of the source was consumed (caller polls faster while behind)."""
        wd = getattr(self.server, 'watchdog', None)
        try:
            size = os.path.getsize(self.cache.manifest_path)
        except OSError:
            size = 0
        cur = self.store.cursor(CURSOR_SOURCE)
        if size < cur:
            # the cache compacted its manifest under us: replay from the
            # top — add_rows dedupes by cache key, del is idempotent
            cur = 0
        lag = max(0, size - cur)
        with self._lock:
            self.ingest_lag_bytes = lag
        self._g_lag.set(lag)
        if wd is not None:
            wd.set_pending(INGEST_WORKER, 1 if lag else 0)
        if not lag:
            return False
        t0 = time.perf_counter()
        with open(self.cache.manifest_path, 'rb') as f:
            f.seek(cur)
            data = f.read(size - cur)
        last_nl = data.rfind(b'\n')
        if last_nl < 0:
            return False                 # torn tail only: wait for more
        chunk = data[:last_nl + 1]
        rows = 0
        for line in chunk.split(b'\n'):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except (ValueError, UnicodeDecodeError):
                continue                 # foreign/torn line: skip
            op, key = rec.get('op'), rec.get('key')
            if not key:
                continue
            if op == 'put':
                added, skipped = fold_put(self.store, self.cache, key, rec)
                rows += added
                if added:
                    self._c_rows.inc(added)
                if skipped:
                    with self._lock:
                        self.objects_skipped += skipped
            elif op == 'del':
                dropped = self.store.drop_key(key)
                if dropped:
                    self._c_dropped.inc(dropped)
        new_cur = cur + len(chunk)
        self.store.set_cursor(CURSOR_SOURCE, new_cur)
        lag = max(0, size - new_cur)
        with self._lock:
            self.ingest_lag_bytes = lag
        self._g_lag.set(lag)
        if wd is not None:
            wd.advance(INGEST_WORKER, 'index_ingest')
            wd.set_pending(INGEST_WORKER, 1 if lag else 0)
        if self._recorder is not None:
            t1 = time.perf_counter()
            self._recorder.span('index_ingest', t0, t1, rows=rows,
                                bytes=len(chunk))
        return True

    # -- queries -------------------------------------------------------------

    def search_vector(self, family: str, vector, k: int = 10,
                      dim: Optional[int] = None) -> Dict[str, Any]:
        t0 = time.perf_counter()
        try:
            queries = np.asarray(vector, dtype=np.float32)
        except (TypeError, ValueError) as e:
            return {'ok': False, 'error': f'malformed query vector: {e}'}
        try:
            hits, _wall = self.engine.search(family, queries, k, dim=dim)
        except ValueError as e:
            return {'ok': False, 'error': str(e)}
        dt = time.perf_counter() - t0
        self._h_query.observe(dt)
        self._c_queries.inc(len(hits))
        if self._recorder is not None:
            self._recorder.span('index_query', t0, t0 + dt, family=family,
                                queries=len(hits), k=k)
        merged = hits[0] if len(hits) == 1 else \
            QueryEngine.merge_hits(hits, k)
        return {'ok': True, 'family': family, 'k': k, 'hits': merged,
                'wall_s': round(dt, 6)}

    def search_by_video(self, video_path: str,
                        features: Optional[List[str]] = None,
                        k: int = 10, timeout_s: Optional[float] = None,
                        priority: str = 'interactive',
                        traceparent: Optional[str] = None,
                        ) -> Dict[str, Any]:
        """Extract ``video_path`` through the server's own (fused)
        submit path, wait for ingest to fold the result in, then query
        each family with the video's own window embeddings."""
        t0 = time.perf_counter()
        deadline = t0 + (DEFAULT_SEARCH_TIMEOUT_S if timeout_s is None
                         else float(timeout_s))
        if not features:
            return {'ok': False,
                    'error': 'search by video requires features: [..]'}
        try:
            from video_features_torch.cache.key import hash_file
            sha = hash_file(video_path)
        except OSError as e:
            return {'ok': False, 'error': f'unreadable video: {e}'}
        result = self.server.submit(
            None, [video_path], features=list(features),
            priority=priority, traceparent=traceparent)
        if not result.get('ok'):
            return result
        rid = result['request_id']
        while time.perf_counter() < deadline:
            st = self.server.status(rid)
            if st.get('ok') and st.get('state') != 'running':
                break
            time.sleep(0.05)
        results: Dict[str, Any] = {}
        errors: Dict[str, str] = {}
        for family in features:
            qvecs: np.ndarray = np.zeros((0, 0), np.float32)
            while time.perf_counter() < deadline:
                qvecs, _ = self.store.rows_for(family, sha)
                if qvecs.shape[0]:
                    break
                time.sleep(0.05)
            if not qvecs.shape[0]:
                errors[family] = ('no indexed rows for this video '
                                  '(extraction failed or ingest timed out)')
                continue
            tq = time.perf_counter()
            try:
                hits, _wall = self.engine.search(family, qvecs, k)
            except ValueError as e:
                errors[family] = str(e)
                continue
            dt = time.perf_counter() - tq
            self._h_query.observe(dt)
            self._c_queries.inc(len(hits))
            if self._recorder is not None:
                self._recorder.span('index_query', tq, tq + dt,
                                    family=family, queries=len(hits),
                                    k=k, request_id=rid)
            results[family] = QueryEngine.merge_hits(hits, k)
        out: Dict[str, Any] = {
            'ok': bool(results) or not errors,
            'request_id': rid, 'video_sha256': sha, 'k': k,
            'results': results,
            'wall_s': round(time.perf_counter() - t0, 6)}
        if errors:
            out['errors'] = errors
            if not results:
                out['error'] = '; '.join(
                    f'{f}: {e}' for f, e in sorted(errors.items()))
        return out

    # -- telemetry -----------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """The serve metrics document's ``index`` section (numeric keys
        mirror to ``vft_index_*`` gauges; names are disjoint from the
        registered counter/histogram families above)."""
        s = self.store.stats()
        with self._lock:
            lag = self.ingest_lag_bytes
            skipped = self.objects_skipped
            errors = self.ingest_errors
        return {'enabled': True,
                'dir': s['dir'],
                'rows_live': s['rows_live'],
                'rows_dead': s['rows_dead'],
                'shards': s['shards'],
                'rows_indexed': s['rows_added'],
                'rows_dropped': s['rows_dropped'],
                'ingest_lag_bytes': lag,
                'objects_skipped': skipped,
                'ingest_errors': errors,
                'queries': self.engine.queries_total,
                'programs_loaded': self.engine.programs_loaded,
                'programs_compiled': self.engine.programs_compiled,
                'families': s['families']}
